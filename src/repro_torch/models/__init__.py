"""The LM stack's models (PyTorch counterpart of repro.models): a generic
decoder covering dense/GQA, MoE, MLA, Mamba-2 SSD, the hybrid interleave, a
vision patch stub and an encoder-decoder audio stub. `model_zoo` is the entry
point: init_params / apply_train / apply_prefill / apply_decode."""

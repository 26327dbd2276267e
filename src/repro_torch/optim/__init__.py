"""AdamW for the LM stack (PyTorch counterpart of repro.optim)."""

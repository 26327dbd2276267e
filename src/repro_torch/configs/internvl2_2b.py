"""InternVL2-2B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B].

InternLM2-1.8B language backbone (24L, GQA kv=8). The InternViT vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings [batch, num_patches, d_model] that are prepended to the
token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    has_vision_stub=True, num_patches=256,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-2b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    has_vision_stub=True, num_patches=8,
)

"""Granite-20B-Code [arXiv:2405.04324; hf] — llama-arch MQA (kv=1) code model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-20b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=16,
)

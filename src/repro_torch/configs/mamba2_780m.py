"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state_dim=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_kernel=4,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
    conv_kernel=4,
)

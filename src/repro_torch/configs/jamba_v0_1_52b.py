"""Jamba-v0.1 (52B) [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1].

Mamba+attention 1:7 interleave (one attention layer per 8, at offset 4),
MoE (16 experts, top-2) on every second layer. DESIGN.md notes: mamba blocks
use our SSD implementation (d_state=16 per the paper); attention layers use a
4096-token sliding window for the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    num_experts=16, num_experts_per_tok=2, moe_d_ff=14336, moe_layer_period=2,
    ssm_state_dim=16, ssm_head_dim=128, ssm_expand=2, ssm_chunk=256,
    conv_kernel=4,
    attn_layer_period=8, attn_layer_offset=4,
    sliding_window=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    num_experts=4, num_experts_per_tok=2, moe_d_ff=128, moe_layer_period=2,
    ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    conv_kernel=4,
    attn_layer_period=8, attn_layer_offset=4,
    sliding_window=64,
)

"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924] — 64e top-8 MoE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    num_experts=64, num_experts_per_tok=8, moe_d_ff=1024,
)

# capacity_factor = E / top_k makes the smoke model *dropless* (capacity >=
# tokens): capacity drops depend on the whole batch, so a dropping forward is
# unreproducible by single-token decode and would break prefill/decode parity.
# The full config keeps the production factor (1.25) — drops are a throughput
# knob at scale, not part of smoke-scale semantics.
SMOKE_CONFIG = ModelConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=128,
    moe_capacity_factor=4.0,
)

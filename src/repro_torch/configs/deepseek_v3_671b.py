"""DeepSeek-V3 (671B) [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

MLA attention (q_lora 1536, kv_lora 512, qk 128+64 rope, v 128);
MoE: 1 shared + 256 routed experts, top-8, expert dim 2048; first 3 layers
dense with d_ff 18432. The MTP head is omitted (DESIGN.md §8).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    num_experts=256, num_experts_per_tok=8, num_shared_experts=1,
    moe_d_ff=2048, first_k_dense=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
    moe_d_ff=32, first_k_dense=1,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
)

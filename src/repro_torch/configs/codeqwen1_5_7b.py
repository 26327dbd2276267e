"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5-arch dense MHA, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
)

SMOKE_CONFIG = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16, qkv_bias=True,
)

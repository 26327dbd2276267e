"""SeamlessM4T-medium [arXiv:2308.11596; hf:facebook/seamless-m4t-medium].

Encoder-decoder transformer backbone (12L + 12L, d=1024, MHA, plain GELU
FFN). The speech frontend is a STUB: input_specs() provides precomputed
frame embeddings [batch, frames, d_model] for the encoder. Decoder performs
text generation over the 256206-entry vocabulary.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    is_encoder_decoder=True, num_encoder_layers=12,
    has_audio_stub=True, act="gelu",
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    is_encoder_decoder=True, num_encoder_layers=2,
    has_audio_stub=True, act="gelu",
)

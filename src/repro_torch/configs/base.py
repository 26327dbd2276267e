"""Model configuration schema + registry for the 10 assigned architectures
(PyTorch counterpart of repro.configs.base; the same fields and values).

The registry names this package's own config modules, so `get_config` loads
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    moe_layer_period: int = 1        # every k-th layer is MoE (jamba: 2)
    first_k_dense: int = 0           # deepseek-v3: first 3 layers dense
    moe_capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / jamba) ---
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    ssm_n_groups: int = 1
    attn_layer_period: int = 0       # hybrid: one attention layer per period
    attn_layer_offset: int = 0

    # --- encoder-decoder (seamless-m4t) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality stubs ---
    has_vision_stub: bool = False    # internvl2: precomputed patch embeds
    num_patches: int = 256
    has_audio_stub: bool = False     # seamless: precomputed frame embeds

    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0          # used by hybrid attn layers at 500k ctx
    act: str = "silu"                # mlp activation: silu (glu) | gelu (plain)

    # How many leading layers are materialized outside the scan.
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_layer_period:
            return i % self.attn_layer_period == self.attn_layer_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.num_experts:
            return False
        if i < self.first_k_dense:
            return False
        return (i % self.moe_layer_period) == (self.moe_layer_period - 1) if self.moe_layer_period > 1 else True

    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => long_500k shape runs."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        from repro_torch.models.model_zoo import count_params_analytic

        return count_params_analytic(self)


_REGISTRY = {
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_REGISTRY)}")
    mod = importlib.import_module(_REGISTRY[arch])
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(_REGISTRY[arch])
    return mod.SMOKE_CONFIG

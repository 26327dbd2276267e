"""AdamW with a cosine schedule, global-norm clipping and optional
reduced-precision moments (PyTorch counterpart of repro.optim.adam).

The state mirrors the parameters by name: `m` and `v` map each parameter
name of the `Model` (its `named_parameters()`) to a tensor of its shape in
`moment_dtype` on its device. `adam_update` updates the parameters and the
moments in place and returns them.

Two rules follow the reference's stacked layout, where a group's parameters
carry a leading units axis and the port's units are separate modules:

* decoupled weight decay applies to a leaf of rank >= 2 in the reference, so
  every parameter inside `groups` / `enc_groups` (norm scales, biases, Mamba's
  A_log / D / dt_bias included) is decayed, and of the top-level parameters
  only the matrices are;
* the global norm sums the squares per stacked leaf, in the order jax
  flattens the reference's tree (dict keys sorted, units in order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple

import torch
from torch import nn

# Top-level entries of the parameter tree whose leaves the reference stacks over units.
STACKED = ("groups", "enc_groups")


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: Any = torch.float32  # bf16 halves the optimizer's memory


class AdamState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor  # int32[]


def named(params) -> Dict[str, torch.Tensor]:
    """A `Model`'s parameters by name, or a mapping of name -> tensor as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def stacked_key(name: str):
    """(the reference's key path of the stacked leaf, unit index or 0) of a
    parameter name: groups.<g>.<unit>.<rest> -> ("groups", g, *rest)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return (parts[0], int(parts[1]), *parts[3:]), int(parts[2])
    return tuple(parts), 0


def decays(name: str, p: torch.Tensor) -> bool:
    """The reference's rule, p.ndim >= 2, on its stacked leaf."""
    return p.ndim + (name.split(".", 1)[0] in STACKED) >= 2


def adam_init(cfg: AdamConfig, params) -> AdamState:
    ps = named(params)
    zeros = {n: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device) for n, p in ps.items()}
    return AdamState(
        m=zeros,
        v={n: torch.zeros_like(z) for n, z in zeros.items()},
        step=torch.zeros((), dtype=torch.int32, device=next(iter(ps.values())).device),
    )


def schedule(cfg: AdamConfig, step):
    """Linear warmup, then cosine to 10% of lr. float32 arithmetic on the
    int32 step, as the reference's (a Python float64 formula differs in the
    last bits)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    """sqrt of the sum of every leaf's squares in fp32: one sum per stacked
    leaf (its units in order), added in the reference's flatten order."""
    leaves: Dict[tuple, list] = {}
    for name, g in named(tree).items():
        key, unit = stacked_key(name)
        leaves.setdefault(key, []).append((unit, g))
    total = 0
    for key in sorted(leaves):
        total = total + sum(torch.sum(g.float() ** 2) for _, g in sorted(leaves[key], key=lambda ug: ug[0]))
    return torch.sqrt(total)


def adam_update(cfg: AdamConfig, params, grads, state: AdamState):
    """One AdamW step. Updates `params` (a `Model` or a mapping of tensors)
    and the moments in place. Returns (params, new_state, metrics). Under
    torch.profiler its work is the range "adam_update"."""
    with torch.no_grad(), torch.profiler.record_function("adam_update"):
        new_state, metrics = _update(cfg, named(params), named(grads), state)
    return params, new_state, metrics


def _update(cfg, ps, gs, state):
    step = state.step + 1
    gnorm = global_norm(gs)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for name, p in ps.items():
        m, v = state.m[name], state.v[name]
        g = gs[name].float() * clip
        mf = m.float() * b1 + (1 - b1) * g
        vf = v.float() * b2 + (1 - b2) * g * g
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if decays(name, p):  # decoupled weight decay
            update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
        m.copy_(mf)
        v.copy_(vf)
    return AdamState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}

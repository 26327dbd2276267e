"""Carry LSM state across between this package and the JAX reference.

The exchange format is a mapping of numpy arrays with the field names of
`repro.core.lsm.LSMState` (`key_vars` and `values` are sequences of one array
per level), which is what `jax.device_get(state)._asdict()` gives. Neither
direction imports JAX: the caller converts on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lsm import LSMConfig, LSMState


def _i32(a, device) -> torch.Tensor:
    # A copy: the state is updated in place and must not alias the caller's arrays.
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def lsm_state_from_numpy(cfg: LSMConfig, fields, device) -> LSMState:
    """Build an `LSMState` on `device` from the JAX state's fields as numpy."""
    kvs, vals = list(fields["key_vars"]), list(fields["values"])
    if len(kvs) != cfg.num_levels or len(vals) != cfg.num_levels:
        raise ValueError(f"expected {cfg.num_levels} levels, got {len(kvs)}/{len(vals)}")
    for i, (kv, val) in enumerate(zip(kvs, vals)):
        if np.shape(kv) != (cfg.level_size(i),) or np.shape(val) != (cfg.level_size(i),):
            raise ValueError(f"level {i} must hold {cfg.level_size(i)} slots")
    b = cfg.batch_size
    buf = {n: np.asarray(fields[n]) for n in
           ("buf_kv", "buf_val", "buf_seq", "buf_sorted_kv", "buf_sorted_val")}
    for name, a in buf.items():
        if a.shape != (b,):
            raise ValueError(f"{name} must have shape ({b},), got {a.shape}")
    return LSMState(
        arena_kv=_i32(np.concatenate([buf["buf_sorted_kv"], *kvs]), device),
        arena_val=_i32(np.concatenate([buf["buf_sorted_val"], *vals]), device),
        buf_kv=_i32(buf["buf_kv"], device),
        buf_val=_i32(buf["buf_val"], device),
        buf_seq=_i32(buf["buf_seq"], device),
        lvl_debt=_i32(fields["lvl_debt"], device),
        r=int(fields["r"]),
        buf_n=int(fields["buf_n"]),
        overflowed=bool(fields["overflowed"]),
    )


def lsm_state_to_numpy(state: LSMState) -> dict:
    """Every `LSMState` field as numpy, under the JAX reference's names and
    dtypes (int32 arrays and scalars, a bool latch)."""
    def host(t):
        return t.detach().cpu().numpy()

    return dict(
        key_vars=tuple(host(t) for t in state.key_vars),
        values=tuple(host(t) for t in state.values),
        r=np.int32(state.r),
        overflowed=np.bool_(state.overflowed),
        buf_kv=host(state.buf_kv),
        buf_val=host(state.buf_val),
        buf_seq=host(state.buf_seq),
        buf_n=np.int32(state.buf_n),
        buf_sorted_kv=host(state.buf_sorted_kv),
        buf_sorted_val=host(state.buf_sorted_val),
        lvl_debt=host(state.lvl_debt),
    )

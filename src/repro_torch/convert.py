"""Carry LSM, sharded-LSM, sorted-array and cuckoo state, and the LM stack's
parameters, caches and AdamW state, across between this package and the JAX
reference.

The exchange format is a mapping of numpy arrays with the field names of
`repro.core.lsm.LSMState` (`key_vars` and `values` are sequences of one array
per level), `repro.core.sorted_array.SAState` or
`repro.core.cuckoo.CuckooTable`, which is what
`jax.device_get(state)._asdict()` gives. The reference's sharded state is an
`LSMState` whose every leaf has a leading shard axis ([S, ...] levels and
buffers, [S] `r`, `buf_n` and `overflowed`); here it is a tuple of one
`LSMState` per shard. A model's parameters and caches travel as the
reference's pytree of numpy arrays (`jax.device_get(params)`): nested dicts
and lists whose group leaves carry a leading unit axis; bf16 leaves arrive
as numpy's 2-byte `bfloat16` extension type. The AdamW moments mirror that
tree there, and the port's parameter names here. Neither direction imports JAX:
the caller converts on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cuckoo import CuckooConfig, CuckooTable
from repro_torch.core.distributed import DistLSMConfig
from repro_torch.core.lsm import LSMConfig, LSMState
from repro_torch.core.sorted_array import SAConfig, SAState
from repro_torch.models import model_zoo
from repro_torch.optim.adam import STACKED, AdamState, named, stacked_key


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


def _host(t) -> np.ndarray:
    # A copy: a CPU tensor's .numpy() would alias state that is updated in place.
    return t.detach().to("cpu", copy=True).numpy()


def lsm_state_to_numpy(state: LSMState) -> dict:
    """Every `LSMState` field as numpy, under the JAX reference's names and
    dtypes (int32 arrays and scalars, a bool latch)."""
    return dict(
        key_vars=tuple(_host(t) for t in state.key_vars),
        values=tuple(_host(t) for t in state.values),
        r=np.int32(state.r),
        overflowed=np.bool_(state.overflowed),
        buf_kv=_host(state.buf_kv),
        buf_val=_host(state.buf_val),
        buf_seq=_host(state.buf_seq),
        buf_n=np.int32(state.buf_n),
        buf_sorted_kv=_host(state.buf_sorted_kv),
        buf_sorted_val=_host(state.buf_sorted_val),
        lvl_debt=_host(state.lvl_debt),
    )


_LEVELS = ("key_vars", "values")


def dist_state_from_numpy(cfg: DistLSMConfig, fields, devices) -> tuple:
    """The reference's stacked sharded state as numpy -> a tuple of
    `LSMState`, shard s on `devices[s]` (copies, as `lsm_state_from_numpy`)."""
    S = cfg.num_shards
    if len(devices) != S:
        raise ValueError(f"expected {S} devices, got {len(devices)}")
    for name, v in fields.items():
        for leaf in (v if name in _LEVELS else (v,)):
            if np.shape(leaf)[:1] != (S,):
                raise ValueError(f"{name} must have a leading shard axis of {S}, got shape {np.shape(leaf)}")
    return tuple(
        lsm_state_from_numpy(
            cfg.local,
            {name: tuple(np.asarray(a)[s] for a in v) if name in _LEVELS else np.asarray(v)[s]
             for name, v in fields.items()},
            dev)
        for s, dev in enumerate(devices))


def dist_state_to_numpy(states) -> dict:
    """A tuple of shard states -> the reference's stacked fields as numpy:
    every `lsm_state_to_numpy` field with a leading shard axis."""
    per = [lsm_state_to_numpy(st) for st in states]
    return {name: tuple(np.stack(level) for level in zip(*(p[name] for p in per))) if name in _LEVELS
            else np.stack([p[name] for p in per]) for name in per[0]}


def sa_state_from_numpy(cfg: SAConfig, fields, device) -> SAState:
    """Build an `SAState` on `device` from the JAX state's fields as numpy."""
    for name in ("key_vars", "values"):
        if np.shape(fields[name]) != (cfg.capacity,):
            raise ValueError(f"{name} must hold {cfg.capacity} slots, got {np.shape(fields[name])}")
    return SAState(
        key_vars=_i32(fields["key_vars"], device),
        values=_i32(fields["values"], device),
        n=_i32(fields["n"], device),
    )


def sa_state_to_numpy(state: SAState) -> dict:
    """Every `SAState` field as numpy, under the JAX reference's names and
    dtypes (int32 arrays and an int32 scalar)."""
    return dict(key_vars=_host(state.key_vars), values=_host(state.values), n=_host(state.n))


def cuckoo_table_from_numpy(cfg: CuckooConfig, fields, device) -> CuckooTable:
    """Build a `CuckooTable` on `device` from the JAX table's fields as numpy."""
    for name in ("slot_keys", "slot_vals"):
        if np.shape(fields[name]) != (cfg.table_size,):
            raise ValueError(f"{name} must hold {cfg.table_size} slots, got {np.shape(fields[name])}")
    return CuckooTable(
        slot_keys=_i32(fields["slot_keys"], device),
        slot_vals=_i32(fields["slot_vals"], device),
        build_ok=bool(fields["build_ok"]),
    )


def cuckoo_table_to_numpy(table: CuckooTable) -> dict:
    """The reference's `CuckooTable` fields as numpy (int32 slot arrays and a
    bool flag); the port's `rounds` is not one of them."""
    return dict(slot_keys=_host(table.slot_keys), slot_vals=_host(table.slot_vals),
                build_ok=np.bool_(table.build_ok))


# -- the LM stack ---------------------------------------------------------------


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf -> a tensor of the same dtype on `device` (a copy). A
    2-byte bfloat16 array is carried bit for bit through a uint16 view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy on the host; bf16 widens to float32 (exact)."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _leaf(tree, path):
    for key in path:
        tree = tree[int(key) if isinstance(tree, (list, tuple)) else key]
    return tree


def _unstacked(tree, name):
    """The reference tree's leaf of the port's parameter `name`: for a group's
    unit, groups.<g>.<unit>.<sub>... -> tree[groups][g][<sub>...][unit]."""
    key, unit = stacked_key(name)
    arr = _leaf(tree, key)
    return np.asarray(arr)[unit] if key[0] in STACKED else arr


def model_params_from_jax(cfg, tree, device) -> "model_zoo.Model":
    """The reference's parameter tree (numpy leaves) -> a `model_zoo.Model`
    on `device`. Each group's stacked [units, ...] leaves are unstacked into
    its units; every leaf keeps its dtype."""
    model = model_zoo.init_params(cfg, device="meta")
    for name, _ in list(model.named_parameters()):
        parts = name.split(".")
        arr = _unstacked(tree, name)
        owner = model.get_submodule(".".join(parts[:-1]))
        if tuple(np.shape(arr)) != tuple(getattr(owner, parts[-1]).shape):
            raise ValueError(f"{name}: shape {np.shape(arr)} != {tuple(getattr(owner, parts[-1]).shape)}")
        setattr(owner, parts[-1], torch.nn.Parameter(_tensor(arr, device)))
    return model


def _stacked_tree(tensors) -> dict:
    """name -> tensor (the port's parameter names) -> the reference's tree:
    nested dicts, a list per group axis, each group leaf stacked over its
    units; numpy, bf16 as float32."""
    leaves: dict = {}
    for name, t in tensors.items():
        key, unit = stacked_key(name)
        leaves.setdefault(key, {})[unit] = _numpy(t)
    tree: dict = {}
    for key, units in leaves.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = np.stack([units[u] for u in sorted(units)]) if key[0] in STACKED else units[0]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in sorted(node)]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def model_params_to_numpy(params) -> dict:
    """A `Model`'s parameters (or name -> tensor) as the reference's tree of
    numpy arrays (group leaves stacked over units; bf16 as float32)."""
    return _stacked_tree(named(params))


def adam_state_from_jax(cfg, state, device) -> AdamState:
    """The reference's `AdamState` (numpy leaves, or a mapping with m, v,
    step) -> the port's: m and v by parameter name on `device`, unstacked as
    `model_params_from_jax` does, each leaf in its stored dtype."""
    get = (lambda k: state[k]) if isinstance(state, dict) else (lambda k: getattr(state, k))
    names = [n for n, _ in model_zoo.init_params(cfg, device="meta").named_parameters()]
    m, v = get("m"), get("v")
    return AdamState(
        m={n: _tensor(_unstacked(m, n), device) for n in names},
        v={n: _tensor(_unstacked(v, n), device) for n in names},
        step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32, device=device),
    )


def adam_state_to_numpy(state: AdamState) -> dict:
    """The port's `AdamState` as the reference's fields: m and v as its
    parameter tree (numpy, bf16 as float32), step an int32 scalar."""
    return dict(m=_stacked_tree(state.m), v=_stacked_tree(state.v), step=np.int32(int(state.step)))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def caches_from_jax(caches, device) -> list:
    """The reference's prefill caches (one dict per group, every leaf
    stacked [units, ...]) -> the port's (one list of per-unit dicts per group)."""
    out = []
    for group in caches:
        units = len(next(iter(_leaves(group))))
        out.append([_map(lambda a, u=u: _tensor(np.asarray(a)[u], device), group) for u in range(units)])
    return out


def caches_to_numpy(caches) -> list:
    """The port's caches -> the reference's layout as numpy (one dict per
    group, each leaf stacked over the group's units; bf16 as float32)."""
    def stack(units):
        if isinstance(units[0], dict):
            return {k: stack([u[k] for u in units]) for k in units[0]}
        return np.stack([_numpy(t) for t in units])

    return [stack(group) for group in caches]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

"""Fault-tolerant checkpointing: atomic, async (PyTorch counterpart of
repro.checkpoint.checkpoint), in the reference's on-disk format.

Format: one directory per step, `step_<n>/`, with one .npy per tree leaf
(path-encoded filenames) and a JSON manifest. Writes go to `step_<n>.tmp/`
and are renamed into place (atomic on POSIX), so a failure mid-write never
corrupts the latest checkpoint. bf16 (and fp8) leaves are stored as an
integer view of the same width, their true dtype in the manifest. Either
package restores what the other wrote: the leaves are flattened in jax's
order (dict keys sorted) and named by jax's key strings (`['a'][0].m`).

A tree is nested dicts, lists, tuples, namedtuples and dataclasses (such as
`LSMState`) over leaves: tensors, numpy arrays and Python scalars. The
device-to-host copy is taken on the caller's thread (the next step updates
the state in place); async mode hands only the file writes to a background
thread, one save in flight at a time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, ClassVar, List, Tuple

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")

# numpy has no bf16 / fp8: they travel as a same-width unsigned view.
_VIEWS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8, torch.float8_e5m2: torch.uint8}
_BY_NAME = {str(dtype).removeprefix("torch."): dtype for dtype in _VIEWS}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A leaf's shape, dtype and device: a restore target that holds no data."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    tree_leaf: ClassVar[bool] = True  # a leaf of a tree, not a node

    @classmethod
    def of(cls, leaf):
        """The spec of a tensor; any other leaf is its own spec."""
        if isinstance(leaf, torch.Tensor):
            return cls(tuple(leaf.shape), leaf.dtype, leaf.device)
        return leaf


# -- trees ----------------------------------------------------------------------


def _node(x):
    """(key strings, children, rebuild) of a tree node, or None for a leaf."""
    if isinstance(x, dict):
        keys = sorted(x)
        return [f"[{k!r}]" for k in keys], [x[k] for k in keys], lambda vals: type(x)(zip(keys, vals))
    if isinstance(x, tuple) and hasattr(type(x), "_fields"):
        return [f".{f}" for f in x._fields], list(x), lambda vals: type(x)(*vals)
    if isinstance(x, (list, tuple)):
        return [f"[{i}]" for i in range(len(x))], list(x), lambda vals: type(x)(vals)
    if dataclasses.is_dataclass(x) and not isinstance(x, type) and not getattr(x, "tree_leaf", False):
        names = [f.name for f in dataclasses.fields(x)]
        return ([f".{n}" for n in names], [getattr(x, n) for n in names],
                lambda vals: dataclasses.replace(x, **dict(zip(names, vals))))
    if x is None:
        return [], [], lambda vals: None
    return None


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], Callable]:
    """([(key string, leaf)] in jax's flatten order, unflatten(leaves))."""
    node = _node(tree)
    if node is None:
        return [("", tree)], lambda leaves: leaves[0]
    keys, children, rebuild = node
    flat, parts = [], []
    for key, child in zip(keys, children):
        sub, unflatten = tree_flatten_with_path(child)
        flat += [(key + p, leaf) for p, leaf in sub]
        parts.append((len(sub), unflatten))

    def unflatten(leaves):
        vals, at = [], 0
        for n, fn in parts:
            vals.append(fn(leaves[at:at + n]))
            at += n
        return rebuild(vals)

    return flat, unflatten


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`)."""
    flat, unflatten = tree_flatten_with_path(tree)
    others = [[leaf for _, leaf in tree_flatten_with_path(r)[0]] for r in rest]
    return unflatten([fn(leaf, *(o[i] for o in others)) for i, (_, leaf) in enumerate(flat)])


def _to_host(leaf) -> np.ndarray:
    """A leaf as numpy in its storable form (a copy: the state is updated in place)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _VIEWS:
            t = t.view(_VIEWS[t.dtype])
        return t.to("cpu", copy=True).numpy(), str(leaf.dtype).removeprefix("torch.")
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _leaf_filename(path_str: str) -> str:
    return _SAFE.sub("_", path_str).strip("_") + ".npy"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree) -> None:
        """Snapshot `tree` at `step` (blocking unless async_save)."""
        flat, _ = tree_flatten_with_path(tree)
        host = [(path, *_to_host(leaf)) for path, leaf in flat]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for path_str, arr, dtype_name in host_leaves:
            fname = _leaf_filename(path_str)
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"path": path_str, "file": fname,
                                       "shape": list(arr.shape), "dtype": dtype_name})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """Rebuild `target_tree`'s structure from disk. A tensor or
        `TensorSpec` leaf of the target gives the shape to check and the
        device to put the stored tensor on (in its stored dtype); a Python
        scalar leaf comes back as a scalar of its type; any other leaf as
        numpy.

        shardings: optional tree of `dist.sharding.Placement`s, matched to
        the target's leaves by key path; a leaf it names goes to its
        placement's device instead, and any other as without it. A placement
        must put its leaf whole on one device (a one-device mesh; every axis
        its spec names of size 1): a plan that would split a leaf raises
        ValueError naming the leaf."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        flat, unflatten = tree_flatten_with_path(target_tree)
        placed = {}
        if shardings is not None:
            placed = {path: pl.device(path) for path, pl in tree_flatten_with_path(shardings)[0]}
            unknown = sorted(set(placed) - {path for path, _ in flat})
            if unknown:
                raise KeyError(f"shardings name leaves the target lacks: {unknown[:3]}")
        leaves = []
        for path_str, spec in flat:
            entry = by_path.get(path_str)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {path_str}")
            arr = np.load(os.path.join(d, entry["file"]))
            shape = tuple(spec.shape) if hasattr(spec, "shape") else np.shape(spec)
            if tuple(arr.shape) != shape:
                raise ValueError(f"{path_str}: shape {arr.shape} != {shape}")
            leaves.append(_from_host(arr, entry["dtype"], spec, placed.get(path_str)))
        return unflatten(leaves)


def _from_host(arr: np.ndarray, dtype_name: str, spec, device=None):
    if isinstance(spec, (torch.Tensor, TensorSpec)):
        t = torch.from_numpy(arr)
        if dtype_name in _BY_NAME:
            t = t.view(_BY_NAME[dtype_name])
        return t.to(spec.device if device is None else device)
    if isinstance(spec, (bool, int, float)):
        return type(spec)(arr.item())
    return arr

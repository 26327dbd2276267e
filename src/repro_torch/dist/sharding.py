"""The sharding plan of the LM stack (PyTorch counterpart of
repro.dist.sharding).

A `Placement` is a (mesh, spec) pair: `spec` holds a PartitionSpec's
entries, one per leading dimension of a leaf (an axis name, a tuple of axis
names, or None), and `()` means replicated. A plan is a pure function of a
leaf's shape and the mesh's axis names and sizes, so it is built, compared
and costed for meshes that do not exist here (`launch.mesh.Mesh` with no
devices). No process group, DeviceMesh or DTensor is made: on one device a
plan places every leaf whole on that device (`place`), and a plan that
would split a leaf raises.

* `hint` / `regather_params_tp` are the reference's in-graph layout
  constraints. They consult an ambient mesh, and the port has none, so they
  are the identity, as the reference's are off-mesh.
* `params_shardings` / `batch_shardings` / `replicated` /
  `stacked_shardings` are the out-of-graph plans. Parameters: shard the last
  model-divisible dimension of every leaf of rank >= 2 over "model", never
  dimension 0. Batches: the leading dimension over "data" (and "pod").

The rule is the reference's on its stacked leaves. A leaf of a unit inside
`groups` / `enc_groups` is [units, ...] there and one module's tensor here,
so the rule is applied to the stacked shape (units axis prepended) and the
units entry, which it never shards, is dropped: a unit's bias [d] is
sharded as the reference's [units, d] is.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import ClassVar, Tuple

import torch

from repro_torch.checkpoint.checkpoint import tree_flatten_with_path, tree_map
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adam import STACKED, named, stacked_key


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: dimension i split over the axes `spec[i]` names."""

    mesh: Mesh
    spec: Tuple = ()
    tree_leaf: ClassVar[bool] = True  # a leaf of a tree, not a node

    def local_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's block of a leaf of `shape`."""
        sizes = [math.prod(self.mesh.shape[n] for n in _names(e)) for e in self.spec]
        sizes += [1] * (len(shape) - len(sizes))
        return tuple(d // s for d, s in zip(shape, sizes))

    def device(self, what: str = "a leaf") -> torch.device:
        """The device this placement puts a leaf on whole. ValueError unless
        the mesh has exactly one device and every axis the spec names has
        size 1: the port does not split a leaf."""
        mesh = self.mesh
        split = [n for e in self.spec for n in _names(e) if mesh.shape[n] > 1]
        if split:
            raise ValueError(f"{what}: the plan splits it over {split} of a {mesh.shape} mesh; "
                             "the port places a leaf whole on one device")
        if mesh.devices is None or len(mesh.devices) != 1:
            raise ValueError(f"{what}: the plan's {mesh.shape} mesh has "
                             f"{'no devices' if mesh.devices is None else f'{len(mesh.devices)} devices'}; "
                             "the port places a leaf whole on one device")
        return mesh.devices[0]


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _clean_entry(mesh, entry, dim: int):
    """Keep only mesh-resident axis names whose product divides `dim`."""
    if entry is None:
        return None
    names = tuple(n for n in _names(entry) if n in mesh.axis_names)
    if not names:
        return None
    size = math.prod(mesh.shape[n] for n in names)
    if size <= 1 or dim % size != 0:
        return None
    return names[0] if len(names) == 1 else names


def hint(x, *spec):
    """Soft sharding constraint; the identity (no ambient mesh)."""
    del spec
    return x


def regather_params_tp(params):
    """ZeRO-3-style regather to replicated; the identity (no ambient mesh)."""
    return params


def replicated(mesh) -> Placement:
    return Placement(mesh, ())


def stacked_shardings(tree, mesh, axis: str):
    """Each leaf's leading (stacking) axis split over `axis`."""
    return tree_map(lambda l: Placement(mesh, (axis,) + (None,) * (len(_shape(l)) - 1)), tree)


def _model_spec(shape, mesh) -> tuple:
    """Shard the last model-divisible dim of a >=2D leaf over "model"."""
    if "model" not in mesh.axis_names or len(shape) < 2:
        return ()
    m = mesh.shape["model"]
    for d in range(len(shape) - 1, 0, -1):  # never the leading (scan/stack) axis
        if m > 1 and shape[d] % m == 0:
            return (None,) * d + ("model",) + (None,) * (len(shape) - d - 1)
    return ()


def params_shardings(cfg, params, mesh, serve: bool = False) -> dict:
    """Parameter name -> Placement, for a `Model` or a mapping of name ->
    tensor or TensorSpec (AdamW's moments too). `serve=True` uses the same
    layout, as in the reference."""
    del cfg, serve
    ps = named(params)
    units = collections.Counter(stacked_key(n)[0] for n in ps)
    plan = {}
    for name, leaf in ps.items():
        key, _ = stacked_key(name)
        if key[0] in STACKED:
            plan[name] = Placement(mesh, _model_spec((units[key],) + _shape(leaf), mesh)[1:])
        else:
            plan[name] = Placement(mesh, _model_spec(_shape(leaf), mesh))
    return plan


def _batch_spec(shape, mesh) -> tuple:
    names = [n for n in ("pod", "data") if n in mesh.axis_names and mesh.shape[n] > 1]
    if not shape or not names:
        return ()
    size = math.prod(mesh.shape[n] for n in names)
    if shape[0] % size != 0:
        return ()
    entry = names[0] if len(names) == 1 else tuple(names)
    return (entry,) + (None,) * (len(shape) - 1)


def batch_shardings(batch, mesh):
    """Data-parallel plan for a batch tree: leading dim over the data axes."""
    return tree_map(lambda l: Placement(mesh, _batch_spec(_shape(l), mesh)), batch)


def place(tree, shardings):
    """Each tensor leaf of `tree` on the device of its placement (the same
    tree structure): jax.device_put(tree, shardings) for one-device plans."""
    flat, unflatten = tree_flatten_with_path(tree)
    plan = tree_flatten_with_path(shardings)[0]
    if [p for p, _ in plan] != [p for p, _ in flat]:
        raise ValueError("the plan's tree differs from the tree's")
    return unflatten([leaf.to(pl.device(path)) if isinstance(leaf, torch.Tensor) else leaf
                      for (path, leaf), (_, pl) in zip(flat, plan)])

"""The port's sharding plan, meshes and input specs (repro_torch.dist.sharding,
repro_torch.launch.mesh, repro_torch.models.model_zoo.input_specs /
cache_specs) against repro's, on the CPU. Exact: every spec entry, shape
and dtype equal.

The reference's rules take a `jax.sharding.AbstractMesh`, so the production
meshes are compared without devices. The reference stacks a group's unit
leaves on a leading axis and the port keeps one tensor a unit: a unit's spec
must equal the reference's stacked spec with its leading entry dropped, and
that entry must be None (the rule never shards dimension 0).

The cases loop inside few test functions: the suite's count of collected
tests sets the chunks pytest-xdist first hands each worker (ROADMAP,
"suite hazards")."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as ref_base
from repro.configs import shapes as ref_shapes
from repro.dist import sharding as RS
from repro.launch import mesh as ref_mesh
from repro.launch import train as ref_train
from repro.models import model_zoo as RZ
from repro_torch.checkpoint.checkpoint import TensorSpec, tree_flatten_with_path
from repro_torch.configs import base as port_base
from repro_torch.configs import shapes as port_shapes
from repro_torch.dist import sharding as PS
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_train
from repro_torch.models import model_zoo as PZ
from repro_torch.optim.adam import STACKED, stacked_key

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
PRODUCTION = ("16x16", "2x16x16")
SHAPES = [(), (7,), (16,), (3584,), (3, 5), (1, 16), (64, 3), (16, 7), (256, 4096), (100352, 2048),
          (2048, 100352), (28, 3584, 18944), (4, 2, 6), (8, 24, 64), (61, 256, 7168, 2048), (5, 3, 1, 2)]
ENTRIES = [None, "data", "model", "pod", "absent", ("pod", "data"), ("data", "model"), ("absent", "model"),
           ("pod", "data", "model"), ()]
DIMS = [1, 2, 3, 4, 8, 16, 32, 48, 64, 256, 512, 3584, 100352]


def meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), port_mesh.make_mesh(sizes, names)


def spec(sharding):
    """A reference NamedSharding's spec as the port's tuple."""
    return tuple(sharding.spec)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else jnp.dtype(dtype).name


def test_clean_entry_model_and_batch_specs_match_reference():
    for mesh in MESHES:
        ref, port = meshes(mesh)
        for entry in ENTRIES:
            for dim in DIMS:
                assert PS._clean_entry(port, entry, dim) == RS._clean_entry(ref, entry, dim), (mesh, entry, dim)
        for shape in SHAPES:
            assert PS._model_spec(shape, port) == tuple(RS._model_spec(shape, ref)), (mesh, shape)
            assert PS._batch_spec(shape, port) == tuple(RS._batch_spec(shape, ref)), (mesh, shape)
    assert PS._model_spec((28, 3584, 18944), meshes("16x16")[1]) == (None, None, "model")


@functools.lru_cache(maxsize=None)
def ref_param_specs(arch):
    cfg = ref_base.get_config(arch)
    return jax.eval_shape(lambda k: RZ.init_params(cfg, k), jax.random.PRNGKey(0))


def ref_leaf(tree, key):
    for k in key:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", PRODUCTION)
def test_params_shardings_match_reference(mesh):
    """Every parameter of the 10 full configs, the port's models built on
    the "meta" device: a top-level leaf's spec equals the reference's, and a
    unit's leaf equals its stacked leaf's with the leading None dropped."""
    for arch in ref_base.ARCH_IDS:
        check_params_shardings(arch, mesh)


def check_params_shardings(arch, mesh):
    ref_mesh_, port_mesh_ = meshes(mesh)
    ref_specs = ref_param_specs(arch)
    ref_sh = RS.params_shardings(None, ref_specs, ref_mesh_)
    model = PZ.init_params(port_base.get_config(arch), device="meta")
    plan = PS.params_shardings(None, model, port_mesh_)
    names = [n for n, _ in model.named_parameters()]
    assert list(plan) == names
    stacked = set()
    for name, p in model.named_parameters():
        key, _ = stacked_key(name)
        exp = spec(ref_leaf(ref_sh, key))
        leaf = ref_leaf(ref_specs, key)
        assert plan[name].mesh == port_mesh_
        if key[0] in STACKED:
            stacked.add(key)
            assert tuple(leaf.shape[1:]) == tuple(p.shape), (arch, name)
            assert exp[:1] in ((), (None,)), (arch, name, exp)
            assert plan[name].spec == exp[1:], (arch, mesh, name, plan[name].spec, exp)
        else:
            assert tuple(leaf.shape) == tuple(p.shape), (arch, name)
            assert plan[name].spec == exp, (arch, mesh, name, plan[name].spec, exp)
    # Every reference leaf is reached; some unit leaf of rank 1 here is
    # sharded (the units axis counts for the rule).
    assert len({stacked_key(n)[0] for n in names}) == len(jax.tree_util.tree_leaves(ref_specs))
    assert any(len(s.spec) == 1 and s.spec[0] == "model" for n, s in plan.items() if stacked_key(n)[0][0] in STACKED)
    # AdamW's moments take the parameters' plan.
    assert PS.params_shardings(None, {n: TensorSpec.of(p) for n, p in model.named_parameters()}, port_mesh_) == plan


def assert_specs_equal(port_tree, ref_tree, what):
    got = [(p, tuple(s.shape), dtype_name(s.dtype), s.device.type) for p, s in tree_flatten_with_path(port_tree)[0]]
    exp = [(jax.tree_util.keystr(p), tuple(s.shape), dtype_name(s.dtype), "meta")
           for p, s in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert got == exp, what


def assert_caches_equal(port_caches, ref_caches, what):
    """The port's caches (per group, one dict per unit) against the
    reference's (per group, every leaf stacked over the units)."""
    assert len(port_caches) == len(ref_caches), what
    for units, ref_group in zip(port_caches, ref_caches):
        ref_flat = [(jax.tree_util.keystr(p), tuple(s.shape), dtype_name(s.dtype))
                    for p, s in jax.tree_util.tree_flatten_with_path(ref_group)[0]]
        for unit in units:
            got = [(p, (len(units),) + tuple(s.shape), dtype_name(s.dtype))
                   for p, s in tree_flatten_with_path(unit)[0]]
            assert got == ref_flat, what


@pytest.mark.parametrize("shape", [s.name for s in ref_shapes.ALL_SHAPES])
def test_input_specs_and_batch_shardings_match_reference(shape):
    """All 40 (arch x shape) cells at full size: the batch (token, cache_len)
    specs exactly, the decode caches as stacked shapes, and the batch plan
    on both production meshes. The port's caches come from a "meta"
    prefill; the reference's from eval_shape."""
    for arch in ref_base.ARCH_IDS:
        check_input_specs(arch, shape)


def check_input_specs(arch, shape):
    ref_cfg, port_cfg = ref_base.get_config(arch), port_base.get_config(arch)
    ref = RZ.input_specs(ref_cfg, ref_shapes.get_shape(shape))
    got = PZ.input_specs(port_cfg, port_shapes.get_shape(shape))
    assert sorted(got) == sorted(ref)
    if "caches" in ref:
        assert_caches_equal(got.pop("caches"), ref.pop("caches"), (arch, shape))
    assert_specs_equal(got, ref, (arch, shape))
    for mesh in PRODUCTION:
        ref_mesh_, port_mesh_ = meshes(mesh)
        ref_sh = RS.batch_shardings(ref, ref_mesh_)
        got_sh = PS.batch_shardings(got, port_mesh_)
        assert [pl.spec for _, pl in tree_flatten_with_path(got_sh)[0]] == [
            spec(s) for s in jax.tree_util.tree_leaves(ref_sh)], (arch, shape, mesh)


def test_cache_specs_equal_a_meta_prefill():
    """cache_specs is what a "meta" prefill returns, a fresh tree each call."""
    cfg = port_base.get_smoke_config("jamba-v0.1-52b")
    model = PZ.init_params(cfg, device="meta")
    with torch.no_grad():
        _, caches = PZ.apply_prefill(cfg, model, {"tokens": torch.empty((3, 40), dtype=torch.int32, device="meta")})
    a, b = PZ.cache_specs(cfg, 3, 40), PZ.cache_specs(cfg, 3, 40)
    assert a == b and a is not b and a[0] is not b[0]
    assert [(p, TensorSpec.of(t)) for p, t in tree_flatten_with_path(caches)[0]] == tree_flatten_with_path(a)[0]


def test_stacked_replicated_hint_regather():
    ref_m, port_m = meshes("4x2")
    tree = {"a": torch.zeros(4, 3), "b": [TensorSpec((8,), torch.int32, torch.device("meta"))]}
    ref_tree = {"a": jax.ShapeDtypeStruct((4, 3), jnp.float32), "b": [jax.ShapeDtypeStruct((8,), jnp.int32)]}
    got = PS.stacked_shardings(tree, port_m, "data")
    exp = RS.stacked_shardings(ref_tree, ref_m, "data")
    assert [s.spec for s in (got["a"], got["b"][0])] == [spec(s) for s in jax.tree_util.tree_leaves(exp)]
    assert PS.replicated(port_m) == PS.Placement(port_m, ()) and spec(RS.replicated(ref_m)) == ()
    x = torch.arange(6.0).reshape(2, 3)
    assert PS.hint(x, ("pod", "data"), "model") is x
    params = {"w": x}
    assert PS.regather_params_tp(params) is params
    # Off-mesh the reference's are the identity too.
    assert RS.hint(jnp.ones(3), "model").shape == (3,)


def test_meshes_match_reference():
    """The production meshes' axes and sizes; make_debug_mesh(2, 2) and
    best_fit_mesh over 4 devices against the reference's over the
    conftest's 4 host devices (both only build a mesh)."""
    for multi_pod, name in ((False, "16x16"), (True, "2x16x16")):
        m = port_mesh.make_production_mesh(multi_pod=multi_pod)
        sizes, names = MESHES[name]
        assert (m.axis_names, m.axis_sizes, m.devices) == (names, sizes, None)
        assert m.shape == dict(AbstractMesh(sizes, names).shape) and m.size == 256 * (1 + multi_pod)
    ref = ref_mesh.make_debug_mesh(2, 2)
    got = port_mesh.make_debug_mesh(2, 2, devices=["cpu"] * 4)
    assert got.shape == dict(ref.shape) and got.axis_names == tuple(ref.axis_names)
    assert port_mesh.make_debug_mesh(1, 2, pod=2).shape == {"pod": 2, "data": 1, "model": 2}
    assert len(jax.devices()) == 4
    got = port_train.best_fit_mesh(["cpu"] * 4)
    assert got.shape == dict(ref_train.best_fit_mesh().shape) == {"data": 1, "model": 4}
    assert port_train.best_fit_mesh(["cpu"]).shape == {"data": 1, "model": 1}
    assert port_train.best_fit_mesh(["cpu"] * 48).shape == {"data": 3, "model": 16}
    with pytest.raises(ValueError):
        port_mesh.make_debug_mesh(2, 2, devices=["cpu"] * 3)


def test_place_puts_leaves_on_the_one_device_and_refuses_a_split():
    one = port_train.best_fit_mesh(["cpu"])
    tree = {"w": torch.ones(4, 16), "n": 3}
    plan = {"w": PS.Placement(one, PS._model_spec((4, 16), one)), "n": PS.replicated(one)}
    placed = PS.place(tree, plan)
    assert placed["w"] is tree["w"] and placed["n"] == 3
    four = port_mesh.make_debug_mesh(1, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match=r"\['w'\].*splits it over \['model'\]"):
        PS.place(tree, {"w": PS.Placement(four, (None, "model")), "n": PS.replicated(four)})
    with pytest.raises(ValueError, match="4 devices"):
        PS.place(tree, {"w": PS.replicated(four), "n": PS.replicated(four)})
    with pytest.raises(ValueError, match="no devices"):
        PS.replicated(port_mesh.make_production_mesh()).device()
    assert PS.Placement(four, (None, "model")).local_shape((4, 16)) == (4, 4)

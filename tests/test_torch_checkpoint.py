"""The port's checkpointing and fault tolerance (repro_torch.checkpoint,
repro_torch.dist.fault_tolerance, the supervised loop of
repro_torch.launch.train) on the CPU, and the on-disk format shared with
repro.checkpoint: a tree written by either package restores in the other.

The port's state is updated in place, so its supervisor keeps the state a
run started with by value; the reference's driver donates its state to the
jitted step and keeps no copy of it, so a failure before the first
checkpoint cannot recover there (pinned below)."""

import functools
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_cases import one_device_mesh
from repro.checkpoint.checkpoint import CheckpointManager as RefCheckpointManager
from repro.launch import train as ref_train
from repro.optim.adam import AdamState as RefAdamState
from repro_torch.checkpoint.checkpoint import CheckpointManager, TensorSpec, tree_flatten_with_path, tree_map
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import LSMConfig, lsm_init, lsm_update
from repro_torch.dist.fault_tolerance import StragglerMonitor, TrainSupervisor
from repro_torch.dist.sharding import Placement, _model_spec, replicated
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.optim.adam import AdamState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 16), generator=g),
        "nested": {"b": torch.arange(16, dtype=torch.int32), "s": torch.tensor(3, dtype=torch.int32)},
    }


def spec_of(tree):
    return tree_map(TensorSpec.of, tree)


def assert_trees_equal(got, exp):
    g, e = tree_flatten_with_path(got)[0], tree_flatten_with_path(exp)[0]
    assert [p for p, _ in g] == [p for p, _ in e]
    for (path, a), (_, b) in zip(g, e):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), path
        else:
            assert type(a) is type(b) and a == b, path


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=2)
        tree = _tree()
        cm.save(7, tree)
        assert_trees_equal(cm.restore(7, spec_of(tree)), tree)
        assert_trees_equal(cm.restore(7, tree), tree)  # a tensor target reads only its shape and device

    def test_retention_gc(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, _tree())
        assert cm.all_steps() == [3, 4]

    def test_async_save_copies_before_the_state_moves_on(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=3, async_save=True)
        tree = _tree()
        cm.save(1, tree)
        expected = tree_map(torch.clone, tree)
        tree["w"].add_(1.0)  # the next step updates the state in place
        cm.wait()
        assert cm.latest_step() == 1
        assert_trees_equal(cm.restore(1, spec_of(tree)), expected)

    def test_atomicity_no_tmp_left(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(5, _tree())
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))

    def test_shape_mismatch_raises(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, _tree())
        bad = tree_map(lambda s: TensorSpec((s.shape[0] + 1,) + s.shape[1:] if s.shape else (2,), s.dtype, s.device),
                       spec_of(_tree()))
        with pytest.raises((ValueError, KeyError)):
            cm.restore(1, bad)
        four = make_debug_mesh(1, 4, devices=["cpu"] * 4)
        with pytest.raises(ValueError, match=r"\['w'\]: the plan splits it over \['model'\]"):
            cm.restore(1, spec_of(_tree()), shardings={"w": Placement(four, (None, "model"))})

    def test_restore_with_a_one_device_plan_equals_restore_without(self, tmp_path):
        """The driver's plan (params, moments) over its one device places
        every leaf there; leaves the plan does not name (the dedup index)
        restore as without one. A plan over several devices, an abstract
        mesh or a leaf the target lacks raises."""
        cm = CheckpointManager(str(tmp_path))
        tree = _tree()
        cm.save(2, tree)
        one = port_train.best_fit_mesh(["cpu"])
        plan = {"w": Placement(one, _model_spec((8, 16), one)), "nested": {"s": replicated(one)}}
        assert_trees_equal(cm.restore(2, spec_of(tree), shardings=plan), cm.restore(2, spec_of(tree)))
        assert_trees_equal(cm.restore(2, spec_of(tree), shardings=plan), tree)
        for bad, match in ((make_debug_mesh(2, 1, devices=["cpu"] * 2), "2 devices"),
                           (make_production_mesh(), "no devices")):
            with pytest.raises(ValueError, match=match):
                cm.restore(2, spec_of(tree), shardings={"w": replicated(bad)})
        with pytest.raises(KeyError, match="lacks"):
            cm.restore(2, spec_of(tree), shardings={"v": replicated(one)})

    def test_host_scalars_and_dataclass_leaves(self, tmp_path):
        """LSMState-like leaves: Python ints and bools come back as such."""
        cfg = LSMConfig(batch_size=4, num_levels=3)
        st = lsm_init(cfg, "cpu")
        for i in range(3):
            keys = torch.arange(4, dtype=torch.int32) * 7 + i
            st = lsm_update(cfg, st, sem.encode_insert(keys), keys)
        cm = CheckpointManager(str(tmp_path))
        cm.save(3, {"index": st})
        got = cm.restore(3, spec_of({"index": st}))["index"]
        assert (got.r, got.buf_n, got.overflowed) == (st.r, st.buf_n, st.overflowed) and type(got.r) is int
        assert_trees_equal(got, st)


def _cross_tree():
    """bf16, int32 and a namedtuple (the optimizer state's type), as numpy."""
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((8, 16)).astype(jnp.bfloat16),
        "nested": {"b": np.arange(16, dtype=np.int32), "s": np.int32(3)},
        "opt": {"m": {"a": rng.standard_normal((4, 3)).astype(np.float32),
                      "b": rng.standard_normal((5,)).astype(jnp.bfloat16)},
                "v": {"a": np.zeros((4, 3), np.float32), "b": np.ones((5,), jnp.bfloat16)},
                "step": np.int32(9)},
    }


def _as_reference(tree):
    opt = tree["opt"]
    return {"w": jnp.asarray(tree["w"]), "nested": jax.tree.map(jnp.asarray, tree["nested"]),
            "opt": RefAdamState(jax.tree.map(jnp.asarray, opt["m"]), jax.tree.map(jnp.asarray, opt["v"]),
                                jnp.asarray(opt["step"]))}


def _as_port(tree):
    def t(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    opt = tree["opt"]
    return {"w": t(tree["w"]), "nested": tree_map(t, tree["nested"]),
            "opt": AdamState(tree_map(t, opt["m"]), tree_map(t, opt["v"]), t(opt["step"]))}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    del m["time"]
    return m


def test_checkpoints_cross_between_packages(tmp_path):
    """Each package restores the other's checkpoint of the same tree, bit
    for bit, and both write the same manifest (leaf order, key paths, file
    names, shapes, dtypes) and the same files."""
    tree = _cross_tree()
    ref_tree, port_tree = _as_reference(tree), _as_port(tree)
    RefCheckpointManager(str(tmp_path / "ref")).save(4, ref_tree)
    CheckpointManager(str(tmp_path / "port")).save(4, port_tree)
    assert _manifest(tmp_path / "ref", 4) == _manifest(tmp_path / "port", 4)
    for entry in _manifest(tmp_path / "ref", 4)["leaves"]:
        a, b = (np.load(tmp_path / d / "step_00000004" / entry["file"]) for d in ("ref", "port"))
        assert a.dtype == b.dtype and np.array_equal(a, b), entry["path"]

    got = CheckpointManager(str(tmp_path / "ref")).restore(4, spec_of(port_tree))
    assert isinstance(got["opt"], AdamState)
    assert_trees_equal(got, port_tree)
    ref_spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ref_tree)
    back = RefCheckpointManager(str(tmp_path / "port")).restore(4, ref_spec)
    assert isinstance(back["opt"], RefAdamState)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


class TestSupervisor:
    def test_restart_after_injected_failure(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=3)
        sup = TrainSupervisor(cm, save_every=2, max_restarts=2)
        fail_at = {5}

        def step_fn(state, step):
            if step in fail_at:
                fail_at.clear()  # fail once
                raise RuntimeError("injected node failure")
            return {"x": state["x"] + 1}

        final, done = sup.run({"x": torch.zeros((), dtype=torch.int32)}, step_fn, num_steps=8)
        assert done == 8
        assert int(final["x"]) == 8  # restart replays steps 4..: value consistent
        assert sup.restarts == 1
        assert any("FAILURE" in line for line in sup.log)

    def test_restart_from_initial_state_is_by_value(self, tmp_path):
        """A step that updates the state in place, failing before any save:
        the restart starts again from the values the run started with."""
        sup = TrainSupervisor(CheckpointManager(str(tmp_path)), save_every=100, max_restarts=1)
        fail_at = {3}

        def step_fn(state, step):
            if step in fail_at:
                fail_at.clear()
                raise RuntimeError("injected node failure")
            state["x"].add_(1)
            state["n"] += 1
            return state

        state = {"x": torch.zeros(4, dtype=torch.int32), "n": 0}
        final, done = sup.run(state, step_fn, num_steps=6)
        assert done == 6 and final["n"] == 6 and torch.equal(final["x"], torch.full((4,), 6, dtype=torch.int32))
        assert "RESTART from initial state (no checkpoint)" in sup.log

    def test_straggler_monitor_flags(self):
        mon = StragglerMonitor(alpha=0.5, threshold=2.0)
        assert not mon.observe(1.0)
        assert not mon.observe(1.1)
        assert mon.observe(10.0)
        assert mon.flagged_steps == 1


# ---------------------------------------------------------------------------
# the driver: resume and restart equal an unbroken run
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--steps", "6", "--batch", "8", "--seq", "1", "--log-every", "1", "--device", "cpu"]


def drive(tmp_path, name, *extra):
    return port_train.run(SMOKE + ["--ckpt-dir", str(tmp_path / name), *extra])


def assert_same_end(got, exp):
    """Parameters, moments and the dedup index (arena, buffers and host
    fields) bit for bit, and the last six logged steps."""
    assert_trees_equal(got["state"], exp["state"])
    keys = ("step", "loss", "grad_norm", "lr", "dups")
    assert [[r[k] for k in keys] for r in got["log"][-6:]] == [[r[k] for k in keys] for r in exp["log"]]


def test_resume_from_checkpoint_equals_unbroken_run(tmp_path):
    unbroken = drive(tmp_path, "a", "--save-every", "3")
    assert sum(r["dups"] for r in unbroken["log"][3:]) > 0  # the restored index is read
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    resumed = drive(tmp_path, "a", "--resume")
    assert [r["step"] for r in resumed["log"]] == [3, 4, 5]
    resumed["log"] = unbroken["log"][:3] + resumed["log"]
    assert_same_end(resumed, unbroken)


def test_restart_from_checkpoint_equals_unbroken_run(tmp_path):
    unbroken = drive(tmp_path, "a")
    restarted = drive(tmp_path, "b", "--fail-at", "4", "--save-every", "2")
    assert "RESTART from checkpoint step 4" in restarted["supervisor_log"]
    assert_same_end(restarted, unbroken)


def test_fail_before_first_save_recovers_where_the_reference_raises(tmp_path, monkeypatch):
    """The reference's driver donates params and moments to its jitted step
    (launch/train.py, donate_argnums=(0, 1)) and its supervisor's
    restart-from-zero copy shares their buffers (tree_map(lambda l: l)), so
    the replayed step reads a donated buffer, every restart, until the
    budget is spent. The port copies the initial state by value and ends
    equal to an unbroken run."""
    argv = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "16", "--log-every", "1", "--fail-at", "2",
            "--save-every", "50"]
    monkeypatch.setattr(ref_train, "best_fit_mesh", one_device_mesh)  # the port's layout, one device
    with pytest.raises(ValueError, match="deleted or donated"):
        ref_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    restarted = port_train.run(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "b")])
    unbroken = port_train.run(argv[:-4] + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "a")])
    assert "RESTART from initial state (no checkpoint)" in restarted["supervisor_log"]
    assert [r["step"] for r in restarted["log"]] == [0, 1, 0, 1, 2, 3, 4, 5]
    assert_same_end(restarted, unbroken)


STEP_LINE = re.compile(r"step\s+(\d+) loss \S+ gnorm \S+ lr \S+ dups (\d+)")


def reference_dups(capsys, argv):
    ref_train.main(argv)
    return [(int(m.group(1)), int(m.group(2))) for m in map(STEP_LINE.search, capsys.readouterr().out.splitlines())
            if m]


def test_resume_keeps_the_dedup_index_where_the_reference_starts_it_empty(tmp_path, monkeypatch, capsys):
    """Kept on purpose. Both drivers on `--smoke --steps 6 --batch 8 --seq 1
    --save-every 3`, then `--resume` after step_00000006 is removed. The
    reference restores only {"params", "opt"} and starts its dedup index
    empty (repro/launch/train.py, `pipe_state = pipeline_init(pcfg)`), so
    its resumed steps count other duplicates than its unbroken run; the port
    restores {"params", "opt", "pipe"} and its resumed counts equal its
    unbroken run's. The unbroken runs agree step for step.

    The reference's driver runs on one device; its dedup runs op by op
    (jax.disable_jit), since jitted, its cascade compiles a 16-branch
    lax.switch at every step; both of its runs share one compiled train
    step. The duplicate counts do not depend on the train step."""
    argv = ["--smoke", "--steps", "6", "--batch", "8", "--seq", "1", "--log-every", "1"]

    def op_by_op(fn):
        def run(*args):
            with jax.disable_jit():
                return fn(*args)
        return run

    monkeypatch.setattr(ref_train, "best_fit_mesh", one_device_mesh)
    monkeypatch.setattr(ref_train, "dedup_batch", op_by_op(ref_train.dedup_batch))
    monkeypatch.setattr(ref_train, "make_train_step", functools.lru_cache(ref_train.make_train_step))
    ref_dir = str(tmp_path / "ref")
    ref_unbroken = reference_dups(capsys, argv + ["--save-every", "3", "--ckpt-dir", ref_dir])
    shutil.rmtree(tmp_path / "ref" / "step_00000006")
    ref_resumed = reference_dups(capsys, argv + ["--resume", "--ckpt-dir", ref_dir])

    port_dir = str(tmp_path / "port")
    port_unbroken = port_train.run(argv + ["--save-every", "3", "--device", "cpu", "--ckpt-dir", port_dir])["log"]
    shutil.rmtree(tmp_path / "port" / "step_00000006")
    port_resumed = port_train.run(argv + ["--resume", "--device", "cpu", "--ckpt-dir", port_dir])["log"]
    port_unbroken = [(r["step"], r["dups"]) for r in port_unbroken]
    port_resumed = [(r["step"], r["dups"]) for r in port_resumed]

    assert port_unbroken == ref_unbroken and [s for s, _ in ref_unbroken] == list(range(6))
    assert [s for s, _ in ref_resumed] == [s for s, _ in port_resumed] == [3, 4, 5]
    assert port_resumed == port_unbroken[3:]
    assert ref_resumed != ref_unbroken[3:]
    assert sum(d for _, d in ref_resumed) < sum(d for _, d in ref_unbroken[3:])

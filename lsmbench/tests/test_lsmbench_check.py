"""The check that decides `correct`: the port agrees with the reference on
every cell at a tiny size on the CPU; the control (the reference with a
guarantee broken) and every fault a cell can have come out not correct."""

import pytest
import torch
from lsmbench_tiny import CELLS, run, tiny

from lsmbench import harness
from lsmbench.reference.dense import DenseDictionary

SEED = 2**31 + 123


def system_faults(cell):
    """{fault: the kind of call it spoils} that the cell's system declares."""
    return harness.load_module("systems", tiny(cell)["config"]["system"]).FAULTS


def _applies(cell, fault):
    c = tiny(cell)
    return system_faults(cell)[fault] in harness.driver(c).calls(c["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(cell):
    c = tiny(cell)
    r, correct, checks = run(c, seed=SEED)
    assert correct, checks
    if c["traffic"]["driver"] != "closed_loop":
        return
    ops = {op["op"] for op in c["traffic"]["round"]}
    assert r.rounds > 1 and r.checked["readback"] > 1024
    for kind in ops - {"update"}:
        assert r.checked[kind] > 0
    if ops & {"count", "range"}:
        # the tiny plan truncates some windows: `ok` is judged both ways
        assert r.failed > 0 and r.checked["ok"] > r.failed


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    from lsmbench import control

    correct, checks, _ = control.run_one(tiny(cell), SEED, 0.3, ["cpu"], control="stale_overwrite")
    assert not correct, checks


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in system_faults(c) if _applies(c, f)])
def test_fault_is_not_correct(cell, fault):
    """Each fault the cell's system declares, in every cell that sends the
    kind of call it spoils: an update that returns its state unchanged, half
    of each batch left out, an answer altered where it is produced (the
    read-back runs lookups, so every closed-loop cell has that one). The
    exchange between chips does not exist on one chip."""
    from lsmbench import control

    correct, checks, _ = control.run_one(tiny(cell), SEED, 0.3, ["cpu"], fault=fault)
    assert not correct, checks


def test_reference_last_lane_wins_and_tombstones_hide():
    ref = DenseDictionary(8, "cpu")
    keys = torch.tensor([5, 7, 5, 9, 7], dtype=torch.int32)
    vals = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    ref.update(keys, vals, torch.tensor([False, False, False, False, True]))
    found, got = ref.lookup(torch.tensor([5, 7, 9, 11], dtype=torch.int32))
    assert found.tolist() == [True, False, True, False]
    assert got.tolist() == [3, 0, 4, 0]
    plan = {"max_candidates": 4, "max_results": 1}
    k1, k2 = torch.tensor([0, 6]), torch.tensor([10, 10])
    counts, ok = ref.count(k1, k2, plan)
    assert counts.tolist() == [2, 1] and ok.tolist() == [True, True]
    rk, rv, rc, rok = ref.range(k1, k2, plan)
    assert rk.tolist() == [[5], [9]] and rv.tolist() == [[3], [4]]
    assert rc.tolist() == [2, 1] and rok.tolist() == [False, True]


def test_expected_ok_follows_the_plan():
    ref = DenseDictionary(8, "cpu", track_writes=True)
    keys = torch.tensor([1, 1, 1, 2, 3], dtype=torch.int32)
    ref.update(keys, torch.arange(5, dtype=torch.int32), torch.zeros(5, dtype=torch.bool))
    plan = {"max_candidates": 4, "max_results": 2}
    k1, k2 = torch.tensor([0, 2, 1]), torch.tensor([3, 3, 1])
    must, may = ref.expected_ok("count", k1, k2, plan)
    assert must.tolist() == [False, True, True] and may.tolist() == [True, True, True]
    must, may = ref.expected_ok("range", k1, k2, plan)
    assert must.tolist() == [False, True, True] and may.tolist() == [False, True, True]

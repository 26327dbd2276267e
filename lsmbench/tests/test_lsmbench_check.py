"""The check that decides `correct`: the port agrees with the reference on
every cell at a tiny size on the CPU; the control (the reference with a
guarantee broken) and every fault a cell can have come out not correct."""

import pytest
import torch
from lsmbench_tiny import CELLS, run, tiny

from lsmbench.faults import FAULTS
from lsmbench.reference.dense import DenseDictionary

SEED = 2**31 + 123


def ops_of(cell):
    return {op["op"] for op in tiny(cell)["traffic"]["round"]}


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(cell):
    r, correct, checks = run(tiny(cell), seed=SEED)
    assert correct, checks
    assert r.rounds > 1 and r.checked["readback"] > 1024
    for kind in ops_of(cell) - {"update"}:
        assert r.checked[kind] > 0
    if ops_of(cell) & {"count", "range"}:
        # the tiny plan truncates some windows: `ok` is judged both ways
        assert r.failed > 0 and r.checked["ok"] > r.failed


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    from lsmbench import control

    correct, checks, _ = control.run_one(tiny(cell), SEED, 0.3, ["cpu"], control="stale_overwrite")
    assert not correct, checks


def _applies(cell, fault):
    kind = fault.split("_")[0]
    return kind not in ("lookup", "count", "range") or kind in ops_of(cell) or fault == "lookup_altered"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS if _applies(c, f)])
def test_fault_is_not_correct(cell, fault):
    """Each fault the cell can have: an update that returns its state
    unchanged, half of each batch left out, an answer altered where it is
    produced (the read-back runs lookups, so every cell has that one). The
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

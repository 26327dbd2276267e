"""The trace summary on a hand-made timeline (nanoseconds)."""

import pytest
import torch
from lsmbench_tiny import CELLS, BENCH, run, tiny

from lsmbench import devtrace, harness

SPANS = [("window", 0, 100), ("update", 10, 30), ("cleanup", 10, 15), ("client", 31, 37), ("lookup", 40, 60)]
# (name, start, end, launched, device): "c" was launched inside the update
# span but starts on the device after it ends; "f" runs inside the lookup
# span on the device's clock but was launched between calls; "g" is the
# client's, the lookup's inputs made between the calls.
OPS = [("a", 11, 14, 10, 0), ("b", 16, 22, 15, 0), ("c", 28, 31, 27, 0), ("g", 34, 36, 33, 0),
       ("d", 45, 50, 41, 0), ("f", 55, 57, 38, 0), ("e", 70, 72, 69, 0)]


def test_summary_of_a_hand_made_timeline():
    s = devtrace.summarize(OPS, SPANS)
    ns = 1e-9
    assert s["window_s"] == pytest.approx(100 * ns) and s["busy_s"] == pytest.approx(23 * ns)
    up = s["groups"]["update"]
    assert (up["calls"], up["launches"]) == (1, 3)
    assert up["wall_s"] == pytest.approx(20 * ns) and up["busy_s"] == pytest.approx(11 * ns)
    assert up["device_s"] == pytest.approx(12 * ns)
    q = s["groups"]["query"]
    assert (q["calls"], q["launches"], q["device_s"]) == (1, 1, pytest.approx(5 * ns))
    assert q["busy_s"] == pytest.approx(7 * ns)
    assert s["groups"]["scan"]["calls"] == 0
    assert s["device_ops"][0] == ["b", pytest.approx(6 * ns)]
    gaps = dict(s["idle_gaps"])
    # [0,11], [57,70], [72,100] between calls; [31,34] while the client made
    # inputs; [14,16], [22,28] in the update call (outside its cleanup);
    # [36,45] (its middle is past the lookup's start) and [50,55] in the lookup
    assert gaps == {"between_calls": pytest.approx(52 * ns), "client": pytest.approx(3 * ns),
                    "update": pytest.approx(8 * ns), "lookup": pytest.approx(14 * ns)}


def test_busy_time_is_averaged_over_devices():
    ops = [("a", 10, 30, 10, 0), ("b", 20, 30, 20, 1)]
    s = devtrace.summarize(ops, [("window", 0, 100), ("update", 5, 40)])
    assert s["busy_s"] == pytest.approx(15e-9)
    assert s["groups"]["update"]["busy_s"] == pytest.approx(20e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_cell_on_the_card(cell):
    """A tiny cell, traced, on the card: correct, every per-layer metric it
    should report read, rooflines at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r, correct, checks = run(tiny(cell), seconds=0.5, seed=2**31 + 9, device="cuda:0", trace=True)
    assert correct, checks
    assert 0 < r.trace["busy_s"] <= r.trace["window_s"]
    for m in harness.cell_metrics(BENCH, cell, True):
        value = harness.load_metric(m["name"])(r)
        assert value is not None, m["name"]
        if m["name"].endswith("_roofline"):
            assert 0 < value <= 100

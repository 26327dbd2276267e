"""The four examples' ports (examples/torch_*.py) against the reference
examples, on the CPU, in this process.

Each dictionary example runs as `python examples/<name>` would, the port
with `--device cpu`, and every line it prints must equal the reference's
line, with two stated exceptions:

* the port's `Dictionary.__repr__` line carries a `device='cpu'` field that
  the JAX facade's has not (`torch_cases.without_device_field` drops it);
* the streaming example's rate line holds a wall time: only its update count
  and its K40c label are compared.

The streaming example keeps its B = 4096: the reference's time (~70-95 s
here) is its compiles and is no shorter at B = 256-1024. The training
example is not trained twice: the reference's driver is held by
test_torch_train.py, so here both examples' argv rules are compared, and the
port runs on the CPU where its final assert must hold and where it must fail.
"""

import pytest

import repro.launch.train
import repro_torch.launch.train
from torch_cases import run_example, without_device_field

RATE = " streamed updates in "


def test_quickstart_matches_reference(capsys, monkeypatch):
    exp = run_example("quickstart.py", [], capsys, monkeypatch)
    got = run_example("torch_quickstart.py", ["--device", "cpu"], capsys, monkeypatch)
    assert got[0].endswith(", device='cpu')")
    assert len(exp) == 12
    assert without_device_field(got) == exp


def test_streaming_updates_matches_reference(capsys, monkeypatch):
    exp = run_example("streaming_updates.py", [], capsys, monkeypatch)
    got = run_example("torch_streaming_updates.py", ["--device", "cpu"], capsys, monkeypatch)
    assert len(got) == len(exp) == 7
    for g, e in zip(got, exp):
        if RATE in e:
            assert g.split(RATE)[0] == e.split(RATE)[0]
            assert g.endswith("on CPU; K40c paper rate: 225 M/s)") and e.endswith("K40c paper rate: 225 M/s)")
        else:
            assert g == e


@pytest.mark.parametrize("variant", ["main", "server", "sharded"])
def test_dictionary_serving_matches_reference(capsys, monkeypatch, variant):
    """--sharded: the reference shards over the conftest's 4 host devices, the
    port puts its 4 shards on the CPU."""
    ref_argv, port_argv = {"main": ([], []), "server": (["--server"], ["--server"]),
                           "sharded": (["--sharded"], ["--sharded", "--shards", "4"])}[variant]
    exp = run_example("dictionary_serving.py", ref_argv, capsys, monkeypatch)
    got = run_example("torch_dictionary_serving.py", port_argv + ["--device", "cpu"], capsys, monkeypatch)
    assert len(exp) == {"main": 7, "server": 10, "sharded": 5}[variant]
    assert got == exp


def test_train_lm_matches_reference(capsys, monkeypatch, tmp_path):
    handed = {}
    for pkg, name in ((repro.launch.train, "train_lm.py"), (repro_torch.launch.train, "torch_train_lm.py")):
        def capture(argv, name=name):
            handed.setdefault(name, []).append(list(argv))
            return [2.0, 1.0]

        monkeypatch.setattr(pkg, "main", capture)
        for argv in ([], ["--smoke"], ["--no-smoke"], ["--steps", "5"]):
            run_example(name, argv, capsys, monkeypatch)
    assert handed["torch_train_lm.py"] == handed["train_lm.py"] == [
        ["--smoke"], ["--smoke"], [], ["--smoke", "--steps", "5"]]
    monkeypatch.undo()

    common = ["--device", "cpu", "--batch", "2", "--seq", "16"]
    lines = run_example("torch_train_lm.py", common + ["--steps", "12", "--log-every", "1",
                                                      "--ckpt-dir", str(tmp_path / "a")], capsys, monkeypatch)
    assert "[train] loss decreased ✓" in lines
    assert sum(ln.startswith("  step ") for ln in lines) == 12
    # The default --log-every 10 logs only step 0 of 6: the reference's own
    # assert then fails, and so does the port's.
    with pytest.raises(AssertionError, match="loss did not decrease"):
        run_example("torch_train_lm.py", common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")],
                    capsys, monkeypatch)

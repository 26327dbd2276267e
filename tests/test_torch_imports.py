"""The port stands alone: no file of repro_torch, and not chip_smoke.py,
imports jax or the JAX package `repro`, and importing repro_torch, or
running an example's port (examples/torch_*.py) to its first line of work,
leaves jax out of the process."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.api, repro_torch.convert, repro_torch.kernels.ops,"
        " repro_torch.models.model_zoo, repro_torch.launch.serve, repro_torch.launch.train,"
        " repro_torch.optim.adam, repro_torch.checkpoint.checkpoint, repro_torch.dist.sharding,"
        " repro_torch.dist.compression, repro_torch.launch.dryrun;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # The examples' ports: none imports jax, jaxlib or repro, by its source
    # and in a process that runs it up to its argument parsing (`--help`).
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == ["torch_dictionary_serving.py", "torch_quickstart.py",
                                          "torch_streaming_updates.py", "torch_train_lm.py"]
    for path in examples:
        bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name} imports {bad}"
    code = (
        "import runpy, sys\n"
        "for path in sys.argv[1:]:\n"
        "    sys.argv = [path, '--help']\n"
        "    try:\n"
        "        runpy.run_path(path, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (path, e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code, *map(str, examples)], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

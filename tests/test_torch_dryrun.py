"""The port's dry run (repro_torch.launch.dryrun), a plan check on the
"meta" device, against the reference's plan, on the CPU. Exact: byte counts
are integers.

Importing repro.launch.dryrun sets XLA_FLAGS to 512 forced host devices for
the whole process (its first lines). jax is up by then, so this process is
not changed, but every subprocess a test worker spawns later would inherit
the flag: the import below runs under monkeypatch.setenv, whose teardown
puts XLA_FLAGS back. The cases loop inside few test functions (ROADMAP,
"suite hazards": the count of collected tests sets pytest-xdist's first
chunks).
"""

import json
import math
import os

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import base as ref_base
from repro.configs.shapes import get_shape
from repro.dist import sharding as RS
from repro.models import model_zoo as RZ
from repro_torch.launch import dryrun

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def ref_dryrun(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as module

    return module


def ref_bytes(tree, shardings):
    """Per-device bytes of a reference tree of ShapeDtypeStructs under its plan."""
    return sum(math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
               for leaf, sh in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(shardings)))


def test_cli_cell_bytes_equal_the_reference_plan(tmp_path, capsys):
    """`--arch stablelm-1.6b --shape train_4k` (and `--multi-pod`)
    in-process: one JSON, the [dryrun] line, and per-device parameter,
    gradient, moment and batch bytes equal to the sums over the reference's
    own specs and plan. deepseek-v3-671b takes bf16 moments."""
    for multi_pod in (False, True):
        check_cli_cell(tmp_path, capsys, multi_pod)
    rec = dryrun.run_cell("deepseek-v3-671b", "train_4k", multi_pod=True)
    pd = rec["per_device_bytes"]
    assert rec["moment_dtype"] == "bfloat16" and pd["moments"] == 2 * pd["params"] + 4


def check_cli_cell(tmp_path, capsys, multi_pod):
    argv = ["--arch", "stablelm-1.6b", "--shape", "train_4k", "--out", str(tmp_path)]
    assert dryrun.main(argv + (["--multi-pod"] if multi_pod else [])) == 0
    tag = f"stablelm-1.6b__train_4k__{'2x16x16' if multi_pod else '16x16'}"
    out = capsys.readouterr().out
    assert f"[dryrun] {tag} ..." in out and "done; 0 failures" in out
    rec = json.loads((tmp_path / f"{tag}.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 * (1 + multi_pod) and rec["moment_dtype"] == "float32"
    assert rec["options"] == {"sharded_loss": False, "remat_policy": "full", "zero3_gather": False,
                              "serve_sharding": False, "attn_seq_shard": False}

    mesh = AbstractMesh(*MESHES[multi_pod])
    cfg = ref_base.get_config("stablelm-1.6b")
    params = jax.eval_shape(lambda k: RZ.init_params(cfg, k), jax.random.PRNGKey(0))
    params_b = ref_bytes(params, RS.params_shardings(cfg, params, mesh))
    batch = RZ.input_specs(cfg, get_shape("train_4k"))["batch"]
    pd = rec["per_device_bytes"]
    assert pd["params"] == pd["grads"] == params_b
    assert pd["moments"] == 2 * 2 * params_b + 4  # fp32 moments of bf16 parameters, and the int32 step
    assert pd["batch"] == ref_bytes(batch, RS.batch_shardings(batch, mesh))
    assert pd["total"] == sum(v for k, v in pd.items() if k != "total")
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / rec["chips"]
    # The largest leaf is an fp32 moment of one unit's tensor (the reference's stacked leaf over its units).
    assert rec["largest_leaf"]["bytes"] == max(
        4 * math.prod(sh.shard_shape(leaf.shape)) // (leaf.shape[0] if path[0].key == "groups" else 1)
        for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                    jax.tree_util.tree_leaves(RS.params_shardings(cfg, params, mesh))))


def test_reference_serve_cells_lack_cache_shardings(ref_dryrun):
    """The reference's build_cell calls sharding.cache_shardings for prefill
    and decode, which repro/dist/sharding.py does not define (a reference
    fault); its train cell builds. The port's cells return records, the
    caches reported replicated."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        if shape == "train_4k":
            ref_dryrun.build_cell("stablelm-1.6b", shape, mesh)
        else:
            with pytest.raises(AttributeError, match="cache_shardings"):
                ref_dryrun.build_cell("stablelm-1.6b", shape, mesh)
        rec = dryrun.run_cell("stablelm-1.6b", shape, multi_pod=False)
        assert rec["status"] == "ok"
        assert rec.get("cache_plan") == (None if shape == "train_4k" else "replicated")
        if shape != "train_4k":
            assert rec["per_device_bytes"]["caches"] > 0 and rec["per_device_bytes"]["logits"] > 0


def test_failed_cell_is_recorded_and_counted(tmp_path, capsys):
    """A full-attention arch has no long_500k cell: an error record, a
    failure in the count and a non-zero exit; an existing record is
    skipped unless --force."""
    argv = ["--arch", "qwen2-7b", "--shape", "long_500k", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 1
    rec = json.loads((tmp_path / "qwen2-7b__long_500k__16x16.json").read_text())
    assert rec["status"] == "error" and rec["error"].startswith("ValueError")
    assert "done; 1 failures" in capsys.readouterr().out
    assert dryrun.main(argv) == 0
    assert "[skip] qwen2-7b__long_500k__16x16 (exists)" in capsys.readouterr().out
    assert dryrun.main(argv + ["--force"]) == 1

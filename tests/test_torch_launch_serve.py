"""The port's serving entry point (repro_torch.launch.serve) against
repro.launch.serve, on the CPU.

Both packages serve qwen2-7b's smoke config with the same parameters (the
reference's tree from a numpy seed, converted) and the same prompts (numpy's
generator seeded 0 in both), through the DictionaryServer and through the
standalone pt_* page table. The page table's results (pages per sequence and
free slots after every wave, the index's r after the final compaction) must
be equal. Every decode step is teacher-forced: the port decodes the token the
reference decoded at that step, so a bf16 near-tie in an argmax cannot fork
the two runs, and its logits are held against the reference's at the
reference's bf16 tolerance.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch

from model_cases import BF16, close, ref_params, to_port
from repro.configs.base import get_smoke_config as ref_smoke
from repro.launch import serve as ref_serve
from repro.models import model_zoo as RZ
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import model_zoo as PZ

ARGS = ["--smoke", "--requests", "4", "--batch", "2", "--gen-tokens", "4"]


def parse_reference(text):
    waves = [{"pages_per_seq": [int(v) for v in m.group(1).split(",")], "free": int(m.group(2))}
             for m in re.finditer(r"pages/seq=\[([^\]]*)\] free=(\d+)", text)]
    return waves, int(re.search(r"index compacted to r=(\d+)", text).group(1))


@pytest.mark.parametrize("direct", [False, True], ids=["server", "direct"])
def test_serve_matches_reference(direct, capsys):
    args = serve.parse_args(ARGS + ["--device", "cpu"] + (["--direct"] if direct else []))
    ref_cfg, cfg = ref_smoke(args.arch), get_smoke_config(args.arch)
    tree = ref_params(ref_cfg)

    steps = []  # (token, logits) of each reference decode step, in order
    ref_decode = jax.jit(functools.partial(RZ.apply_decode, ref_cfg))

    def recording(params, token, caches, cache_len):
        logits, caches = ref_decode(params, token, caches, cache_len)
        steps.append((np.asarray(token), np.asarray(logits.astype(np.float32))))
        return logits, caches

    run = ref_serve._run_direct if direct else ref_serve._run_server
    run(args, ref_cfg, tree, recording, np.random.default_rng(0))
    ref_waves, ref_r = parse_reference(capsys.readouterr().out)

    forced = iter(enumerate(steps))

    def teacher_forced(params, token, caches, cache_len):
        i, (ref_token, ref_logits) = next(forced)
        logits, caches = PZ.apply_decode(cfg, params, torch.tensor(ref_token, dtype=torch.long), caches, cache_len)
        close(logits, ref_logits, BF16, f"decode step {i}")
        return logits, caches

    got = serve.serve(args, cfg, to_port(cfg, tree), decode=teacher_forced)
    assert next(forced, None) is None, "the port decoded fewer steps than the reference"
    assert got["waves"] == ref_waves
    assert got["r"] == ref_r == 0 and got["live_pages"] == 0
    pages = args.prompt_len // args.page_size
    assert all(w["pages_per_seq"] == [pages] * args.batch and w["free"] == 1024 - pages * args.batch
               for w in got["waves"])
    assert got["tokens"] == args.requests * args.gen_tokens
    assert capsys.readouterr().out.count("pages/seq=") == len(ref_waves)


def test_main_serves_end_to_end_on_the_cpu(capsys):
    out = serve.main(ARGS + ["--device", "cpu", "--prompt-len", "12", "--page-size", "4"])
    text = capsys.readouterr().out
    assert [w["pages_per_seq"] for w in out["waves"]] == [[3, 3], [3, 3]]
    assert [w["free"] for w in out["waves"]] == [1018, 1018]
    assert out["r"] == 0 and out["live_pages"] == 0 and out["tokens"] == 16
    assert out["stats"]["device_steps"] > 0 and "server:" in text and "tok/s" in text
    assert [p.shape for p in out["prompts"]] == [(2, 12), (2, 12)]
    assert out["params_count"] == PZ.count_params_analytic(out["cfg"])
    assert out["model"].embed.device.type == "cpu" and out["prefill_s"] > 0 and out["decode_s"] > 0


def test_device_defaults_to_the_card_and_raises_without_one(monkeypatch):
    assert serve.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(ARGS)


def test_refuses_encoder_decoder():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu"])

"""End-to-end training driver example on an NVIDIA card with PyTorch.

Trains a reduced-config LM for a few hundred steps with the full stack of
repro_torch.launch.train: the train step with remat, the LSM-dedup data
pipeline (its lookup, batch sort and cascade merge are hand-written CUDA
kernels), async checkpointing, fault injection and restart, straggler
monitoring. The arguments are the driver's; `--smoke` is added unless
`--smoke` or a `--no-smoke*` is given, and a `--no-smoke*` is dropped.

  python examples/torch_train_lm.py                                  # 200 steps, tiny, on the card
  python examples/torch_train_lm.py --arch olmoe-1b-7b --steps 100
  python examples/torch_train_lm.py --fail-at 60                     # FT demo
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 12 --batch 2 --seq 16 --log-every 1

On the card, --no-smoke trains the full config, e.g.
  python examples/torch_train_lm.py --no-smoke --arch stablelm-1.6b --batch 8 --seq 2048 --steps 12 --log-every 1
"""

import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--smoke" not in argv and not any(a.startswith("--no-smoke") for a in argv):
        argv = ["--smoke"] + argv
    argv = [a for a in argv if not a.startswith("--no-smoke")]
    losses = main(argv)
    assert losses and losses[-1] < losses[0], "loss did not decrease"

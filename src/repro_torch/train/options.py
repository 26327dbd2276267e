"""Performance knobs the models take (PyTorch counterpart of
repro.train.options). Every option preserves semantics and is off by default.

On one device the sharding knobs (`sharded_loss`, `zero3_gather`,
`serve_sharding`, `attn_seq_shard`) change nothing: they act through the
reference's in-graph `hint` / `regather_params_tp`, which the port has
(dist/sharding.py) as the identity, as the reference's are without an
ambient mesh; the dry run records them. `remat_policy` sets how the
training forward rematerialises each unit (models/transformer.py);
`scan_unroll` drove the reference's compile-based cost accounting, which
the port's dry run (a plan check) does not do.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PerfOptions:
    # Vocab-sharded cross entropy (a mesh layout; no effect on one device).
    sharded_loss: bool = False
    # ZeRO-3 weight regather per unit (a mesh layout; no effect on one device).
    zero3_gather: bool = False
    # Inference layout for serve steps (a mesh layout; no effect on one device).
    serve_sharding: bool = False
    # Sequence-sharded attention activations (a mesh layout; no effect on one device).
    attn_seq_shard: bool = False
    # Rematerialization: "full" (per-unit checkpoint, baseline), "dots", "none".
    remat_policy: str = "full"
    # Unroll layer scans: 0 = keep loops, -1 = full unroll, u > 0 = u units
    # per loop iteration. Only the dry run's cost accounting reads it.
    scan_unroll: int = 0


BASELINE = PerfOptions()


def resolve(options: "PerfOptions | None") -> PerfOptions:
    return options if options is not None else BASELINE

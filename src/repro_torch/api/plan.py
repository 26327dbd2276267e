"""QueryPlan: the static sizing contract for COUNT/RANGE queries.

The fixed-shape count/range pipeline (core/queries.py) needs two static
bounds: `max_candidates` (stage-3 gather tile width) and `max_results`
(range output width). The facade bundles them into a frozen dataclass that
carries an auto-sizing heuristic and stays overridable in one place (the
same logic as repro.api.plan).

Results carry an `ok` flag: False means the plan's bounds truncated the
answer — re-issue with a bigger explicit plan for exactness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Static sizing for ordered queries. `None` fields are auto-sized.

    max_candidates: per-query candidate-tile width (paper stage 3). Bounds
      the stale+live elements a single [k1, k2] interval may overlap.
    max_results: per-query RANGE output width (ignored by COUNT).
    """

    max_candidates: Optional[int] = None
    max_results: Optional[int] = None

    def __post_init__(self):
        for f in ("max_candidates", "max_results"):
            v = getattr(self, f)
            if v is not None and v < 1:
                raise ValueError(f"{f} must be >= 1, got {v}")

    def resolved(self, max_candidate_bound: int) -> "QueryPlan":
        """Concrete plan for a dictionary whose queries can overlap at most
        `max_candidate_bound` elements (static capacity plus any write-buffer
        slots — `Backend.max_query_candidates`; clamping to bare capacity
        would make a full-structure query inexact with no plan able to fix
        it once the buffer holds residents).

        Heuristic: exact (full bound) while the tile stays small (<= 4096);
        beyond that, the power of two at ~bound/4 (min 4096) — a bounded
        tile that is still generous for the paper's query widths (expected
        range lengths 8..1024). `ok=False` in results signals the heuristic
        was too small for a particular query mix.
        """
        bound = max_candidate_bound
        mc = self.max_candidates
        if mc is None:
            mc = bound if bound <= 4096 else max(4096, 1 << (bound.bit_length() - 3))
        mc = min(mc, bound)
        mr = self.max_results if self.max_results is not None else mc
        return QueryPlan(max_candidates=mc, max_results=mr)

"""Backend protocol and registry for the `Dictionary` facade.

A backend is a frozen description of one dictionary implementation: it owns
the core's static config and the device its state lives on, and adapts the
core's free functions to a uniform method surface. Capability flags make the
paper's Table 1 machine-checkable: an op a backend cannot answer raises
`CapabilityError` up front.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, Dict, NamedTuple, Tuple, Type

from repro_torch.api.plan import QueryPlan

BackendState = Any


class OccupancyStats(NamedTuple):
    """Structural counters for serving schedulers; no query machinery runs."""

    pending: Any   # staged write-buffer elements awaiting a flush
    resident: Any  # elements resident in the main structure (stale included)
    debt: Any      # estimated reclaimable stale elements (maintenance target)


class CapabilityError(NotImplementedError):
    """An operation the chosen backend cannot support (paper Table 1)."""


class KeyDomainError(ValueError):
    """Keys outside [0, MAX_USER_KEY]: they would alias the placebo key or flip
    sign under the `key << 1` status-bit encoding and silently corrupt
    ordering (core/semantics.py)."""


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can do. Flags mirror the paper's Table 1 columns."""

    supports_updates: bool
    supports_deletes: bool
    supports_ordered_queries: bool
    supports_cleanup: bool
    supports_bulk_build: bool = True
    supports_maintenance: bool = False


class Backend(abc.ABC):
    """Adapter from one core to the facade's uniform surface."""

    name: ClassVar[str]
    caps: ClassVar[Capabilities]

    @property
    @abc.abstractmethod
    def batch_size(self) -> int:
        """Width b of one encoded update batch (the facade splits to this)."""

    @property
    @abc.abstractmethod
    def capacity(self) -> int:
        """Maximum resident encoded elements, stale included."""

    @property
    def max_query_candidates(self) -> int:
        """Largest number of resident elements one [k1, k2] window can
        overlap; QueryPlan auto-sizing clamps to it."""
        return self.capacity

    @property
    def has_write_buffer(self) -> bool:
        """Does this backend stage updates in a write buffer (flush and
        pending are meaningful) rather than apply them at once? Serving
        schedulers gate their occupancy and flush policies on it."""
        return False

    @property
    def num_shards(self) -> int:
        """Device partitions behind this backend (1: a single device)."""
        return 1

    @classmethod
    @abc.abstractmethod
    def from_options(cls, **options) -> "Backend":
        """Build from `Dictionary.create(...)` keyword options."""

    @abc.abstractmethod
    def init(self) -> BackendState:
        """Empty state."""

    def bulk_build(self, keys, values) -> BackendState:
        raise CapabilityError(self._no("bulk_build"))

    def update_encoded(self, state: BackendState, key_vars, values) -> BackendState:
        """Apply one b-wide encoded batch (key variables + values) under the
        paper's in-batch rule."""
        raise CapabilityError(self._no("update"))

    def stage_encoded(self, state: BackendState, key_vars, values, count: int) -> BackendState:
        """Stage one b-wide encoded sub-batch whose `count` real lanes are at
        the front in arrival order; the later lane is the newer write."""
        raise CapabilityError(self._no("update"))

    def flush_state(self, state: BackendState, min_pending: int = 1) -> BackendState:
        del min_pending
        return state

    def pending_count(self, state: BackendState) -> int:
        del state
        return 0

    def occupancy(self, state: BackendState) -> OccupancyStats:
        return OccupancyStats(pending=self.pending_count(state), resident=0, debt=0)

    def flush_cost(self, state: BackendState) -> int:
        del state
        return 0

    @abc.abstractmethod
    def lookup(self, state: BackendState, keys) -> Tuple[Any, Any]:
        """Batched LOOKUP -> (found, values)."""

    def count(self, state: BackendState, k1, k2, plan: QueryPlan):
        raise CapabilityError(self._no("count"))

    def range(self, state: BackendState, k1, k2, plan: QueryPlan):
        raise CapabilityError(self._no("range"))

    def cleanup(self, state: BackendState) -> BackendState:
        raise CapabilityError(self._no("cleanup"))

    def maintain_state(self, state: BackendState, budget: int | None, *,
                       only_if_debt: bool = False) -> BackendState:
        del budget, only_if_debt
        return state

    @abc.abstractmethod
    def size(self, state: BackendState):
        """Live (visible) element count as an int32 scalar tensor."""

    @abc.abstractmethod
    def overflowed(self, state: BackendState) -> bool:
        """Has any update exceeded static capacity?"""

    def _no(self, op: str) -> str:
        alts = [n for n, c in _REGISTRY.items() if n != self.name and _op_supported(c, op)]
        return (
            f"backend {self.name!r} does not support {op!r}"
            + (f"; use backend={alts!r}" if alts else "")
        )


def _op_supported(cls: Type[Backend], op: str) -> bool:
    caps = cls.caps
    return {
        "update": caps.supports_updates,
        "insert": caps.supports_updates,
        "delete": caps.supports_deletes,
        "count": caps.supports_ordered_queries,
        "range": caps.supports_ordered_queries,
        "cleanup": caps.supports_cleanup,
        "maintain": caps.supports_maintenance,
        "bulk_build": caps.supports_bulk_build,
        "lookup": True,
    }.get(op, False)


_REGISTRY: Dict[str, Type[Backend]] = {}


def register_backend(cls: Type[Backend]) -> Type[Backend]:
    """Class decorator: make a Backend reachable via Dictionary.create(name)."""
    if not getattr(cls, "name", None):
        raise ValueError(f"backend class {cls.__name__} must define a name")
    _REGISTRY[cls.name] = cls
    return cls


# Backends of repro.api that this package does not have yet, with the
# ROADMAP.md item that ports each.
_NOT_YET_PORTED = {
    "lsm_sharded": "ROADMAP.md queue A item 10 (core/distributed.py)",
}


def get_backend_class(name: str) -> Type[Backend]:
    try:
        return _REGISTRY[name]
    except KeyError:
        later = f"; {name!r} is not ported yet: {_NOT_YET_PORTED[name]}" if name in _NOT_YET_PORTED else ""
        raise KeyError(f"unknown backend {name!r}; this package has {sorted(_REGISTRY)}{later}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))

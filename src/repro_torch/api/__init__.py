"""The `Dictionary` facade over the port's backends: the paper's GPU LSM
("lsm"), its two baselines, the sorted array ("sorted_array") and the static
cuckoo hash ("cuckoo"), and the range-partitioned sharded LSM
("lsm_sharded").

    from repro_torch.api import Dictionary

    d = Dictionary.create("lsm", capacity=1 << 20)   # on the card
    d = d.insert(keys, values)            # any length: split into b-wide sub-batches
    found, vals = d.lookup(queries)
    counts, ok = d.count(k1, k2)          # QueryPlan auto-sized, override available

Unsupported ops raise `CapabilityError` naming the backend and the backends
that do support the op (paper Table 1); `maintain` is LSM-only.
"""

from repro_torch.api.backend import (  # noqa: F401
    Backend,
    BackendState,
    Capabilities,
    CapabilityError,
    KeyDomainError,
    OccupancyStats,
    available_backends,
    get_backend_class,
    register_backend,
)
from repro_torch.api.plan import QueryPlan  # noqa: F401
from repro_torch.api.dictionary import ConsumedHandleError, Dictionary  # noqa: F401

# Importing the module registers the built-in backends.
from repro_torch.api import backends as _builtin_backends  # noqa: F401,E402

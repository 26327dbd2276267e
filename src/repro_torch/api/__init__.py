"""The `Dictionary` facade over the port's backends (the "lsm" backend so far)."""

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

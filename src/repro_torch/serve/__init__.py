"""Serving layer: the continuous-batching dictionary server and its tenants
(PyTorch counterpart of repro.serve).

`DictionaryServer` multiplexes many logical clients onto one device-resident
`Dictionary`, namespacing tenant keys into the shared 30-bit key space and
coalescing queued ops into per-op-kind device steps. `traffic` generates
serving-shaped multi-tenant op traces; `kvcache` is the KV-cache page table,
standalone (`pt_*`) or as a tenant of the server (`ServerPageTable`).
"""

from repro_torch.serve.server import (
    DictionaryServer,
    ServerConfig,
    ServerStats,
    Tenant,
    Ticket,
)
from repro_torch.serve.traffic import TraceOp, TrafficGen, make_trace

__all__ = [
    "DictionaryServer",
    "ServerConfig",
    "ServerStats",
    "Tenant",
    "Ticket",
    "TraceOp",
    "TrafficGen",
    "make_trace",
]

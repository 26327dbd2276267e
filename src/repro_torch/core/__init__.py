"""The LSM's functional core on device tensors: encoding, cascade, updates,
queries, cleanup, and the sorted-array baseline (core/sorted_array.py)."""

from repro_torch.core.lsm import (  # noqa: F401
    LSMConfig,
    LSMState,
    lsm_init,
    lsm_update,
    lsm_stage,
    lsm_flush,
    lsm_insert,
    lsm_delete,
    lsm_update_mixed,
    lsm_bulk_build,
    lsm_num_elements,
    lsm_debt,
    level_runs,
    buffer_run,
    all_runs,
    compact_real,
)
from repro_torch.core.queries import (  # noqa: F401
    lsm_lookup,
    lsm_count,
    lsm_range,
    lookup_runs,
    count_runs,
    range_runs,
)
from repro_torch.core.cleanup import lsm_cleanup, lsm_maintain, lsm_valid_count  # noqa: F401

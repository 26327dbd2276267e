"""Key-variable encoding (paper §4.1) on int32 tensors.

A key variable is the 31-bit original key shifted left once, with the low bit
as the status bit (1 = regular element, 0 = tombstone). Sorting by the full
key variable puts a tombstone for key k before any regular element of k;
merges compare original keys only (`kv >> 1`). Original keys of the domain
[0, PLACEBO_KEY] keep every key variable non-negative in int32, so signed
comparisons order exactly like the paper's unsigned ones.

Empty slots hold *placebo* elements: the reserved maximum original key with
tombstone status (paper §4.5, footnote 6). They sort last in every run and no
query reports them.
"""

from __future__ import annotations

import torch

PLACEBO_KEY = (1 << 30) - 1          # reserved original key for padding
MAX_USER_KEY = PLACEBO_KEY - 1       # largest insertable original key

STATUS_REGULAR = 1
STATUS_TOMBSTONE = 0

PLACEBO_KV = (PLACEBO_KEY << 1) | STATUS_TOMBSTONE
EMPTY_VALUE = 0

INT32_MAX = (1 << 31) - 1


def as_int32(x, device=None) -> torch.Tensor:
    """`x` as an int32 tensor (no copy when it already is one on `device`)."""
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def encode(keys, is_tombstone) -> torch.Tensor:
    """Pack original keys and status bits; `is_tombstone` True marks a delete."""
    keys = as_int32(keys)
    tomb = torch.as_tensor(is_tombstone, dtype=torch.bool, device=keys.device)
    return (keys << 1) | (~tomb).to(torch.int32)


def encode_insert(keys) -> torch.Tensor:
    return (as_int32(keys) << 1) | STATUS_REGULAR


def encode_delete(keys) -> torch.Tensor:
    return (as_int32(keys) << 1) | STATUS_TOMBSTONE


def original_key(key_vars) -> torch.Tensor:
    """Strip the status bit (key variables are non-negative)."""
    return as_int32(key_vars) >> 1


def status_bit(key_vars) -> torch.Tensor:
    return as_int32(key_vars) & 1


def is_tombstone(key_vars) -> torch.Tensor:
    return status_bit(key_vars) == STATUS_TOMBSTONE


def is_placebo(key_vars) -> torch.Tensor:
    return original_key(key_vars) == PLACEBO_KEY


def placebo(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`n` placebo slots: (PLACEBO_KV key variables, EMPTY_VALUE values)."""
    return (
        torch.full((n,), PLACEBO_KV, dtype=torch.int32, device=device),
        torch.full((n,), EMPTY_VALUE, dtype=torch.int32, device=device),
    )

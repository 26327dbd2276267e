"""repro_torch.core.semantics against repro.core.semantics: constants and the
key-variable encoding over the edges of the key domain (exact, integers)."""

import numpy as np
import pytest
import torch

from repro.core import semantics as jsem
from repro_torch.core import semantics as tsem

EDGE_KEYS = np.array(
    [0, 1, 2, 1000, jsem.MAX_USER_KEY - 1, jsem.MAX_USER_KEY, jsem.PLACEBO_KEY], dtype=np.int32
)


@pytest.mark.parametrize(
    "name",
    ["PLACEBO_KEY", "MAX_USER_KEY", "STATUS_REGULAR", "STATUS_TOMBSTONE", "PLACEBO_KV", "EMPTY_VALUE"],
)
def test_constants_match(name):
    assert getattr(tsem, name) == getattr(jsem, name)


def test_int32_max_constant():
    assert tsem.INT32_MAX == np.iinfo(np.int32).max


@pytest.mark.parametrize("tomb", [False, True, "mixed"])
def test_encode_matches(tomb):
    is_tomb = (np.arange(EDGE_KEYS.size) % 2 == 0) if tomb == "mixed" else np.full(EDGE_KEYS.size, tomb)
    got = tsem.encode(torch.from_numpy(EDGE_KEYS), torch.from_numpy(is_tomb))
    exp = np.asarray(jsem.encode(EDGE_KEYS, is_tomb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("fn", ["encode_insert", "encode_delete"])
def test_encode_single_status(fn):
    got = getattr(tsem, fn)(torch.from_numpy(EDGE_KEYS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jsem, fn)(EDGE_KEYS)))


@pytest.mark.parametrize("fn", ["original_key", "status_bit", "is_tombstone", "is_placebo"])
def test_decoders_match(fn):
    kv = np.concatenate(
        [np.asarray(jsem.encode_insert(EDGE_KEYS)), np.asarray(jsem.encode_delete(EDGE_KEYS))]
    )
    got = getattr(tsem, fn)(torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jsem, fn)(kv)))


def test_placebo_slots():
    kv, val = tsem.placebo(5, "cpu")
    assert kv.dtype == val.dtype == torch.int32
    assert (kv == jsem.PLACEBO_KV).all() and (val == jsem.EMPTY_VALUE).all()

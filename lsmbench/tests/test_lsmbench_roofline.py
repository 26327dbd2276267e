"""The per-operation byte counts of lsmbench/roofline.py against hand-worked
small shapes, counted by the LSM adapter from the port's own counters."""

import torch
from lsmbench_tiny import ROOT  # noqa: F401  (sets the paths)

from lsmbench import harness, roofline


def facade(b: int = 4, levels: int = 4):
    config = {"backend": "lsm", "validate": True, "flush_threshold": None, "maintenance_budget": None,
              "capacity": b * ((1 << levels) - 1), "batch_size": b}
    return harness.load_module("systems", "lsm_facade").make(config, [torch.device("cpu")])


def fill(sys, calls: int, b: int = 4):
    for k in range(calls):
        keys = torch.arange(k * b, (k + 1) * b, dtype=torch.int32)
        sys.update(keys, keys, torch.zeros(b, dtype=torch.bool))


def test_update_carry_through_levels_0_to_2():
    # b = 4: eight calls of 4 lanes leave levels 0-2 full (r = 7) and a full
    # write buffer; the ninth pushes the buffer's 4 lanes into level 3,
    # merging 4 + 4 + 8 + 16.
    sys = facade()
    fill(sys, 8)
    assert (sys.d.state.r, sys.d.pending()) == (7, 4)
    keys = torch.arange(100, 104, dtype=torch.int32)
    nbytes = sys.update(keys, keys, torch.zeros(4, dtype=torch.bool))
    assert (sys.d.state.r, sys.d.pending()) == (8, 4)
    # batch read 4 x 8 B, sorted batch written 4 x 8 B; carry and levels 0-2
    # read (32 elements x 8 B), level 3 written (32 x 8 B)
    assert nbytes == roofline.update_bytes(4, 4, [3]) == 32 + 32 + 256 + 256


def test_update_without_a_push():
    sys = facade()
    keys = torch.arange(4, dtype=torch.int32)
    assert sys.update(keys, keys, torch.zeros(4, dtype=torch.bool)) == 64   # the first batch only fills the buffer
    assert (sys.d.state.r, sys.d.pending()) == (0, 4)


def test_cleanup():
    # r = 8 and 4 pending: 36 resident slots read, 10 survivors written
    sys = facade()
    fill(sys, 9)
    assert sys.cleanup(10) == roofline.cleanup_bytes(36, 10) == 8 * 46


def test_fits_follows_the_port():
    """`fits` is true exactly while the port's update would not overflow:
    ragged calls until it says no, then the call it refused overflows."""
    sys = facade(16, 4)
    gen = torch.Generator().manual_seed(0)
    for lanes in (16, 5, 16, 40, 3, 16, 16, 27, 1) + (16,) * 20:
        keys = torch.randint(0, 1 << 20, (lanes,), generator=gen, dtype=torch.int32)
        if not sys.fits(lanes):
            break
        sys.update(keys, keys, torch.zeros(lanes, dtype=torch.bool))
        assert not sys.d.overflowed()
    else:
        raise AssertionError("every call fitted")
    sys.update(keys, keys, torch.zeros(lanes, dtype=torch.bool))
    assert sys.d.overflowed()


def test_lookups_and_ranges():
    assert roofline.lookup_bytes(8) == 8 * (4 + 1 + 4)
    # two windows returning 3 and 5 rows: bounds 2 x 8 B, counts 2 x 4 B and
    # ok 2 x 1 B, rows 8 x 8 B
    assert roofline.count_bytes(2) == 26
    assert roofline.range_bytes(2, 8) == 26 + 64


def test_share_against_the_published_peak():
    assert roofline.share(3_350_000_000, 1.0, "NVIDIA H100 80GB HBM3") == 0.1
    assert roofline.share(1, 1.0, "cpu") is None
    assert roofline.share(1, 0.0, "NVIDIA H100 80GB HBM3") is None

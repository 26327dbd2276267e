"""The least bytes each dictionary operation moves, and the table of peaks.

A share of the roofline is the least time (these bytes over the card's
published memory bandwidth) divided by the device time of every kernel
inside the operation's spans. The bytes are per operation, not per kernel,
so a share reads the same work whatever implements it. An element is a key
and a value, 8 bytes; each input is read once and each output written once.

* Update call of `lanes` lanes: the batch read once and the sorted batch
  written once; then for each batch the binary-counter carry pushes into
  level j, the carry and levels 0..j-1 (b * 2^j elements) read once and
  level j (b * 2^j elements) written once. The system's adapter
  (`systems/<name>.py`) says which levels a call's carries land in.
* Cleanup: every resident slot read once and every survivor written once.
* Lookup of n keys: the keys read (4 bytes each), the found flags (1 byte)
  and values (4 bytes) written.
* Count of n windows: the bounds read (8 bytes a window), the counts (4) and
  ok flags (1) written. Range: the same, plus each row it returns (8 bytes).
"""

from __future__ import annotations

ELEMENT = 8   # int32 key variable + int32 value
KEY = 4
VALUE = 4
FLAG = 1
COUNT = 4

# Published memory bandwidth, bytes per second, by `torch.cuda.get_device_name()`.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM5 data sheet
}


def placement_level(r: int) -> int:
    """The level a carry lands in: the lowest zero bit of r."""
    return ((~r) & (r + 1)).bit_length() - 1


def update_bytes(batch_size: int, lanes: int, levels) -> int:
    """One update call of `lanes` lanes whose carries landed in `levels`."""
    return ELEMENT * (2 * lanes + sum(2 * batch_size << j for j in levels))


def cleanup_bytes(resident: int, survivors: int) -> int:
    return ELEMENT * (resident + survivors)


def lookup_bytes(n: int) -> int:
    return n * (KEY + FLAG + VALUE)


def count_bytes(n: int) -> int:
    return n * (2 * KEY + COUNT + FLAG)


def range_bytes(n: int, rows: int) -> int:
    return count_bytes(n) + rows * ELEMENT


def share(nbytes: int, device_s: float, device_name: str):
    """Percent of the roofline: least time over device time; None without
    device time or a known peak."""
    peak = PEAK_BYTES_PER_S.get(device_name)
    if peak is None or device_s <= 0:
        return None
    return 100.0 * nbytes / peak / device_s


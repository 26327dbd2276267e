import pytest
from lsmbench_tiny import harness


@pytest.fixture(autouse=True)
def small_readback(monkeypatch):
    """Read back in calls of 512 keys, so a tiny run sends several."""
    monkeypatch.setattr(harness.load_module("drivers", "closed_loop"), "READBACK_CHUNK", 512)

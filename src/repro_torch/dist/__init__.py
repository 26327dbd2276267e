"""Fault tolerance of the training loop (PyTorch counterpart of
repro.dist.fault_tolerance); the multi-device layer is not ported yet."""

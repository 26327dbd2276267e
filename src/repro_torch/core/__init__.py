"""The LSM's functional core on device tensors: encoding, cascade, queries, cleanup."""

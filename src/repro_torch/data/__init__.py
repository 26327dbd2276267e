"""The training data path: the synthetic pipeline with LSM-backed dedup."""

"""Training-side options the models take (PyTorch counterpart of repro.train)."""

"""Training-side options and step functions (PyTorch counterpart of repro.train)."""

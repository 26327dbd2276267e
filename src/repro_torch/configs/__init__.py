"""Model configurations of the LM stack (PyTorch counterpart of repro.configs):
the 10 published architectures, each as `CONFIG` (full width) and
`SMOKE_CONFIG` (a reduced same-family config), and the dry-run input shapes."""

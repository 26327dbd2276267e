"""Entry points and device placement (PyTorch counterpart of repro.launch):
`serve` serves an LM (`python -m repro_torch.launch.serve`); `train` trains
one (`python -m repro_torch.launch.train`); `dryrun` checks the sharding plan
of every (arch x shape) cell on the production meshes (`python -m
repro_torch.launch.dryrun`); `mesh` describes the meshes and places the
shards of the `lsm_sharded` dictionary."""

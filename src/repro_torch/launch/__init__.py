"""Entry points and device placement (PyTorch counterpart of repro.launch):
`serve` serves an LM (`python -m repro_torch.launch.serve`); `train` trains
one (`python -m repro_torch.launch.train`); `mesh.make_shard_mesh` places the
shards of the `lsm_sharded` dictionary."""

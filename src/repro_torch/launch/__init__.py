"""Device placement for the port's sharded structures (PyTorch counterpart of
repro.launch): `mesh.make_shard_mesh` places the shards of the `lsm_sharded`
dictionary."""

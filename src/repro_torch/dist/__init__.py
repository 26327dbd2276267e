"""The training stack's multi-device layer (PyTorch counterpart of
repro.dist): the sharding plan (`sharding`), int8 gradient compression with
error feedback (`compression`) and fault tolerance (`fault_tolerance`). No
process group is made: a plan is a function of shapes and a mesh
description, and a cross-rank combine is one controller over per-rank trees."""

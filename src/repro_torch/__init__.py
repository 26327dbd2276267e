"""PyTorch and CUDA port of the GPU LSM dictionary (the JAX package `repro` is
the reference).

    from repro_torch.api import Dictionary

    d = Dictionary.create("lsm", capacity=1 << 20)   # on the card
    d = d.insert(keys, values)
    found, vals = d.lookup(queries)

The package imports torch, numpy and the standard library only. Its hot
spots are hand-written CUDA kernels (`csrc/`), built with nvcc at first use;
on CPU tensors the same functions run their plain PyTorch versions.
"""

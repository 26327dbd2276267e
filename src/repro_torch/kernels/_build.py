"""Build the CUDA sources under `repro_torch/csrc/` and bind them with ctypes.

Each `.cu` file is compiled by its own `nvcc` into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the shared header, so an
edited source is rebuilt and a stale library is never loaded. Libraries are
built at first use (or all at once, in parallel, by `build_all`) into
`build/repro_torch/` at the root of the checkout. Nothing is compiled or
loaded when a module is imported: the CPU tests import every module on a
machine with no `nvcc`.

Every C entry returns `cudaGetLastError()`; `Kernel.launch` raises when it is
not 0 and counts the launch otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Most runs one launch takes: the size of the RunSet arrays in csrc/common.cuh.
MAX_RUNS = 32

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


class Kernel:
    """One CUDA source, its C entry point, and the count of its launches.

    `also` maps further C entries of the source that launch the same kernel
    (another form of its arguments) to their ctypes argument types; they
    share the count."""

    def __init__(self, source: str, symbol: str, argtypes, *, also: dict | None = None):
        self.source = CSRC / source
        self.symbol = symbol
        self.entries = {symbol: list(argtypes), **{name: list(t) for name, t in (also or {}).items()}}
        self.launches = 0
        self.build_log = ""
        self._fns = None
        self._constants = {}

    @property
    def library(self) -> Path:
        h = hashlib.sha1()
        for path in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def _start_build(self):
        """Start nvcc for this source unless its library exists; returns the
        process (or None) and the temporary output path."""
        lib = self.library
        if lib.exists():
            return None, None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, proc, tmp) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
        os.replace(tmp, self.library)

    def build(self) -> None:
        self._finish_build(*self._start_build())

    def _load(self):
        if self._fns is None:
            self.build()
            lib = ctypes.CDLL(str(self.library))
            fns = {}
            for name, argtypes in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            self._fns = fns
        return self._fns

    def constant(self, name: str) -> int:
        """The int that the source's C entry `name` returns: an entry that
        takes no arguments and launches nothing (a compile-time constant of
        the kernel, such as a tile size). Not a launch."""
        if name not in self._constants:
            self._load()
            fn = getattr(ctypes.CDLL(str(self.library)), name)
            fn.argtypes, fn.restype = [], ctypes.c_int
            self._constants[name] = fn()
        return self._constants[name]

    def launch(self, device: torch.device, *args, entry: str | None = None) -> None:
        """Call a C entry (the first by default) on `device`, on PyTorch's
        current stream of that device; raise on a CUDA error.

        The device is made current only when it is not already (the C entry
        launches into the current CUDA context), and the stream is read as a
        raw handle: a launch costs the host one ctypes call and little else."""
        name = entry or self.symbol
        fn = (self._fns or self._load())[name]
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        stream = torch._C._cuda_getCurrentRawStream(index)  # the handle of the current stream
        if index == current:
            err = fn(*args, stream)
        else:
            with torch.cuda.device(index):
                err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUDA error {err}")
        self.launches += 1


def build_all(kernels) -> None:
    """Build every kernel's library, one nvcc per source, all started together."""
    by_source = {k.source: k for k in kernels}
    started = [(k, *k._start_build()) for k in by_source.values()]
    for k, proc, tmp in started:
        k._finish_build(proc, tmp)
    for k in kernels:
        k._load()


def run_pointers(kvs, vals=None):
    """ctypes arrays of the run pointers and lengths for a RunSet argument.
    Without `vals` the value pointers are the key pointers (a launch that
    reads keys only)."""
    k = len(kvs)
    if not 1 <= k <= MAX_RUNS:
        raise ValueError(f"a launch takes 1 to {MAX_RUNS} runs, got {k}")
    lens = [t.shape[0] for t in kvs]
    kvp = (P * k)(*[t.data_ptr() for t in kvs])
    if vals is None:
        return kvp, kvp, (I64 * k)(*lens)
    if [t.shape[0] for t in vals] != lens:
        raise ValueError(f"run kv/val lengths differ: {lens} vs {[t.shape[0] for t in vals]}")
    return kvp, (P * k)(*[t.data_ptr() for t in vals]), (I64 * k)(*lens)


def check_cuda_int32(name: str, *tensors) -> torch.device:
    """Check that every tensor is a contiguous 1-D int32 tensor on one CUDA
    device, and return that device. (Integer device indices and flags keep
    the check cheap: it runs on every launch.)"""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous 1-D int32 CUDA tensors, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.get_device() != index:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and {t.device}; a launch takes one device")
    return tensors[0].device

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
        self.entries = {symbol: list(argtypes), **{name: list(t) for name, t in (also or {}).items()}}
        self.launches = 0
        self.build_log = ""
        self._fns = None

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

    def launch(self, device: torch.device, *args, entry: str | None = None) -> None:
        """Call a C entry (the first by default) on `device`, on PyTorch's
        current stream of that device; raise on a CUDA error."""
        name = entry or next(iter(self.entries))
        fn = self._load()[name]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
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


def run_pointers(kvs, vals):
    """ctypes arrays of the run pointers and lengths for a RunSet argument."""
    k = len(kvs)
    if not 1 <= k <= MAX_RUNS:
        raise ValueError(f"a launch takes 1 to {MAX_RUNS} runs, got {k}")
    for kv, val in zip(kvs, vals):
        if kv.shape != val.shape:
            raise ValueError(f"run kv/val lengths differ: {kv.shape[0]} vs {val.shape[0]}")
    return (
        (P * k)(*[t.data_ptr() for t in kvs]),
        (P * k)(*[t.data_ptr() for t in vals]),
        (I64 * k)(*[t.shape[0] for t in kvs]),
    )


def check_cuda_int32(name: str, *tensors) -> torch.device:
    """Check that every tensor is a contiguous 1-D int32 tensor on one CUDA
    device, and return that device."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous 1-D int32 CUDA tensors, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}; a launch takes one device")
    return device

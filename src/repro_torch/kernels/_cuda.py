"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use (or up front, all sources in parallel, through
``build_all``) into ``build/torch_kernels/`` at the root of the checkout;
the library's file name carries a hash of its sources, so an edited
source never loads a stale build.  Nothing here runs at import time.

A ``CudaKernel`` also keeps the kernel's launch counter: a plain integer
that ``launch`` raises by one per launch and nothing else touches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


class CudaKernel:
    """One ``csrc/<source>.cu``: its library, its C entry point
    ``symbol`` (which returns ``cudaGetLastError()``), and its count of
    launches."""

    def __init__(self, source: str, symbol: str, argtypes: tuple):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha1()
        for f in [CSRC / f"{self.source}.cu"] + sorted(CSRC.glob("*.cuh")):
            h.update(f.read_bytes())
        return BUILD_DIR / f"lib{self.source}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source; None when already built.
        Returns ``(process, tmp_path, log_path)``."""
        lib = self.lib_path
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        log = lib.with_suffix(".log")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{self.source}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, log

    def finish_build(self, started) -> str:
        """Wait for ``start_build``'s nvcc; install the library; return
        the compiler's output (ptxas register/shared-memory report)."""
        if started is None:
            return ""
        proc, tmp, log = started
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}.cu "
                               f"(rc {proc.returncode}):\n{out}")
        os.replace(tmp, self.lib_path)
        return out

    def _load(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            fn = getattr(ctypes.CDLL(str(self.lib_path)), self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args):
        """Launch on PyTorch's current stream (appended as the last
        argument); raise if the launch was refused."""
        fn = self._load()
        rc = fn(*args, P(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}")
        self.launches += 1


def build_all(kernels) -> dict:
    """Build every kernel's source at once, one ``nvcc`` per source, all
    started together.  Returns {source: compiler output}."""
    started = [(k, k.start_build()) for k in kernels]
    return {k.source: k.finish_build(s) for k, s in started}


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return P(None if t is None else t.data_ptr())


def check_cuda(name: str, t: torch.Tensor, dtype, shape=None):
    """The checks a kernel's wrapper owes its C entry point: device,
    dtype, contiguity and (optionally) shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")

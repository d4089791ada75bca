"""Device selection, kernel builds and launch checks.

Counterpart of rustexp_tpu/core/platform.py. The JAX package picks its
backend through jax's platform config; here every function takes an
explicit ``torch.device`` and the kernels are hand-written CUDA C++ for
Hopper (sm_90a), built at first use from the sources in ``csrc/`` with
nvcc into ``build/rustexp_tpu_torch/`` beside the package, and loaded
through ctypes with a plain C interface.

No fallback: a kernel wrapper given a CUDA tensor launches its kernel or
raises; only CPU tensors take the plain PyTorch version. A build that
fails, a missing nvcc and a refused launch all raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rustexp_tpu_torch"

# -fmad=false: nvcc would otherwise contract a*b+c into one FMA, while the
# reference (and the JAX package's sealed CPU chains, ops/ieee.py) rounds
# the product and the sum separately. No -use_fast_math: divisions and
# int->float conversions must round to nearest. -Xptxas=-v: ptxas reports
# each kernel's registers and spills, kept beside the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def device(kind: str | torch.device | None = None) -> torch.device:
    """The device to run on: the card for None or ``"cuda"`` (raises
    without one), the CPU only when the caller asks for ``"cpu"``."""
    dev = torch.device("cuda" if kind is None else kind)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but none is "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_on(dev: torch.device, tensors, what: str) -> None:
    """Raise unless every tensor lies on `dev`: a state built on the CPU
    must not run the plain versions on a card Experiment, nor the reverse."""
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, the experiment on "
                             f"{dev}; build it with device={dev}")


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


class KernelLib:
    """One compiled ``csrc/<name>.cu``: the ctypes handle and how it was made.

    ``build_seconds`` is the nvcc wall time of this process's build (0.0
    when an identical build was already on disk); ``ptxas`` is what ptxas
    said of each kernel when the library was built.
    """

    def __init__(self, name: str, path: Path, build_seconds: float):
        self.name = name
        self.path = path
        self.build_seconds = build_seconds
        log = path.with_suffix(".ptxas.txt")
        self.ptxas = log.read_text() if log.exists() else ""
        self.lib = ctypes.CDLL(str(path))
        self.lib.rustexp_cuda_error_string.restype = ctypes.c_char_p
        self.lib.rustexp_cuda_error_string.argtypes = [ctypes.c_int]

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if rc != 0:
            msg = self.lib.rustexp_cuda_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


@functools.cache
def load_kernel_lib(name: str) -> KernelLib:
    """Build (if its content hash is new) and load ``csrc/<name>.cu``.

    The library file name carries a hash of the source and the flags, so
    an edited source always rebuilds and a stale ``.so`` is never loaded.
    """
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src.name} "
                               f"({' '.join(cmd)}):\n{res.stderr}")
        out.with_suffix(".ptxas.txt").write_text(res.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return KernelLib(name, out, seconds)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

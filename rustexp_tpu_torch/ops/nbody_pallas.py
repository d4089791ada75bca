"""Brute-force N-body forces through kernel B5, the main brute path.

Port of rustexp_tpu/ops/nbody_pallas.py. The math is nbody_forces' (the
reference's nbody.rs:164-184): per target i, the kernel sums
m_j * d / (|d|^2 + EPS) over every source j, d = p_j - p_i, with an exact
or an approximate reciprocal, and the m_i factor is a torch multiply
outside it. The self pair adds exactly zero (d = 0).

Kernel B5 (csrc/nbody_forces.cu, replacing ``_kernel``) runs for CUDA
tensors; forces_pallas_plain is its plain version and serves CPU tensors.
The plain version always takes the exact reciprocal: the approximate
kernel is held against it with its own tolerance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.trace import span
from ..runtime import load_kernel_lib, ptr, stream_ptr
from .nbody_forces import EPS, euler

T_TILE = 1024  # the JAX kernel's targets per grid step; N must divide by it
_PLAIN_CHUNK = 1024  # sources per pass of the plain version


def forces_pallas_plain(px, py, m):
    """Plain PyTorch version of kernel B5 -> (fx, fy) without the m_i
    factor, with the exact reciprocal. Sources go in chunks, [N, chunk]
    at a time, each chunk reduced and added in order, as the TPU kernel
    reduces each source chunk into its output block."""
    fx = torch.zeros_like(px)
    fy = torch.zeros_like(py)
    for lo in range(0, px.shape[0], _PLAIN_CHUNK):
        xs, ys, ms = (a[lo:lo + _PLAIN_CHUNK] for a in (px, py, m))
        dx = xs[None, :] - px[:, None]
        dy = ys[None, :] - py[:, None]
        rm = torch.reciprocal(dx * dx + dy * dy + EPS) * ms[None, :]
        fx = fx + (rm * dx).sum(dim=1)
        fy = fy + (rm * dy).sum(dim=1)
    return fx, fy


B5_TARGETS = 256  # targets per block: 128 threads, 2 targets each
# Blocks a call aims for: splitting the sources over more blocks hid more
# latency; at N = 131,072 an H100 took 6.44, 5.89 and 5.71 ms with 2, 8
# and 16 splits (1,024, 4,096 and 8,192 blocks).
B5_MIN_BLOCKS = 8192
B5_MAX_SPLITS = 16


def _b5_plan(n: int) -> tuple[int, int]:
    """(splits, launches) of a B5 call at N = n: the fewest source splits,
    a power of two up to B5_MAX_SPLITS, that give B5_MIN_BLOCKS blocks;
    one launch for one split, two (the partials' fixed-order sum) for
    more, none at n = 0."""
    if n <= 0:
        return 1, 0
    blocks = -(-n // B5_TARGETS)
    splits = 1
    while splits < B5_MAX_SPLITS and blocks * splits < B5_MIN_BLOCKS:
        splits *= 2
    return splits, 1 + (splits > 1)


@functools.cache
def _b5_kernel():
    lib = load_kernel_lib("nbody_forces")
    fn = lib.lib.nb_forces
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)]
    return lib, fn


# nb_forces' `recip`: the exact reciprocal, the approximate, and the exact
# with the __frcp_rn loop on every tile, which the tests hold the guarded
# loop to
B5_EXACT, B5_APPROX, B5_EXACT_RN_LOOP = 0, 1, 2


def _launch_b5(px, py, m, recip: int):
    """Kernel B5 with nb_forces' `recip` -> (fx, fy) without the m_i
    factor, for contiguous f32 [N] CUDA tensors."""
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"kernel B5 runs on CUDA tensors, got {dev}")
    n = px.shape[0]
    for name, t in (("px", px), ("py", py), ("m", m)):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous f32 [{n}] tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    lib, fn = _b5_kernel()
    fallback = forces_pallas_cuda.fallback_tiles
    if fallback is None or fallback.device != dev:
        fallback = forces_pallas_cuda.fallback_tiles = torch.zeros(
            (), dtype=torch.int64, device=dev)
    fx = torch.empty_like(px)
    fy = torch.empty_like(py)
    splits, _ = _b5_plan(n)
    scratch = torch.empty(2 * splits * n if splits > 1 else 0,
                          dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    rc = fn(ptr(px), ptr(py), ptr(m), ptr(fx), ptr(fy),
            ptr(scratch) if splits > 1 else None, n, recip, splits,
            ptr(fallback), stream_ptr(dev), ctypes.byref(launched))
    forces_pallas_cuda.launches += launched.value
    lib.check(rc, "kernel B5 (nb_forces)")
    return fx, fy


def forces_pallas_cuda(px, py, m, approx_recip: bool = False):
    """Launch kernel B5 (csrc/nbody_forces.cu) -> (fx, fy) without the
    m_i factor, for contiguous f32 [N] CUDA tensors.

    ``forces_pallas_cuda.launches`` counts the grid launches, as
    ``_b5_plan`` gives them: 2 a call at N = 131,072 (16 splits).
    ``forces_pallas_cuda.fallback_tiles``, an int64 tensor on the device
    of the calls (None before the first; a call on another device starts
    a new one), counts the (block, tile) visits in which a coordinate
    beyond the kernel's bound sent the exact kernel to its __frcp_rn loop;
    the kernel adds to it and nothing reads it unless asked.
    """
    return _launch_b5(px, py, m, B5_APPROX if approx_recip else B5_EXACT)


forces_pallas_cuda.launches = 0
forces_pallas_cuda.fallback_tiles = None


def forces_pallas(px, py, m, src_chunk: int = 1024,
                  approx_recip: bool = False):
    """All-pairs forces, (fx, fy) with the reference's m_i * m_j. CUDA
    tensors launch kernel B5 (either reciprocal), CPU tensors take its
    plain version (always exact).

    `src_chunk` keeps the JAX signature and only checks that N divides by
    it, as N must by T_TILE: the JAX kernel's source block, while B5
    stages its own tile of sources."""
    n = px.shape[0]
    if n % T_TILE or n % src_chunk:
        raise ValueError(f"N = {n} must be a multiple of {T_TILE} and of "
                         f"src_chunk {src_chunk}")
    if px.device.type == "cuda":
        fx, fy = forces_pallas_cuda(px, py, m, approx_recip)
    elif px.device.type == "cpu":
        fx, fy = forces_pallas_plain(px, py, m)
    else:
        raise ValueError(f"no N-body forces for device {px.device}")
    return fx * m, fy * m


def step_brute_pallas(px, py, vx, vy, m, src_chunk: int = 1024,
                      approx_recip: bool = False, dt: float = 0.01):
    """Euler step on forces_pallas (nbody.rs:150-161 semantics); the
    forces are the span ``nbody.brute``, the update ``nbody.integrate``."""
    with span("nbody.brute"):
        fx, fy = forces_pallas(px, py, m, src_chunk, approx_recip)
    with span("nbody.integrate"):
        return euler(px, py, vx, vy, m, fx, fy, dt)

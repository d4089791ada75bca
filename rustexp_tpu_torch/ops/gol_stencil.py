"""Game of Life torus stencils and kernel B8 (the fused f32 stencil).

Port of rustexp_tpu/ops/gol_stencil.py. Reference semantics: gol_step,
rs-src/gol.rs:31-170: the 8-neighbour sum with torus wrap and the rule
``alive_nb == 3 || (alive && alive_nb == 2)`` (gol.rs:79).

  * step_roll   — 8 circular shifts and the rule; the readable oracle.
  * step_mxu    — the 3x3 box sum as two circulant products,
                  box = A @ G @ A^T, nb = box - G. A plain product, left to
                  torch.matmul as the JAX package left it to XLA.
  * multi_step  — k generations of either, a Python loop.
  * multi_step_pallas — k generations of the f32 stencil in kernel B8
                  (csrc/gol_stencil.cu) for CUDA tensors, its plain
                  version (multi_step_pallas_plain) for CPU tensors.

Every form is exact: cells are 0/1 and the counts are small integers, so
all of them give the same grid bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..runtime import load_kernel_lib, ptr, stream_ptr

GRID_WDH = 256  # reference gol.rs:8

# The JAX kernel's guard: the grid must stay resident in the TPU's scoped
# VMEM (rustexp_tpu/ops/gol_stencil.py:146-152). Kept so the port raises
# where JAX raises; kernel B8 itself tiles any size.
MAX_PALLAS_CELLS = 640 * 1024


def _rule(alive: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    return ((nb == 3) | ((alive == 1) & (nb == 2))).to(torch.int32)


def step_roll(grid: torch.Tensor) -> torch.Tensor:
    """One generation; grid is an int-typed [h, w] of {0, 1}. Torus wrap."""
    g = grid.to(torch.int32)
    up, down = torch.roll(g, 1, 0), torch.roll(g, -1, 0)
    nb = (up + down + torch.roll(g, 1, 1) + torch.roll(g, -1, 1)
          + torch.roll(up, 1, 1) + torch.roll(up, -1, 1)
          + torch.roll(down, 1, 1) + torch.roll(down, -1, 1))
    return _rule(g, nb).to(grid.dtype)


@functools.lru_cache(maxsize=8)
def _circulant_111_np(n: int) -> np.ndarray:
    """I + shift(+1) + shift(-1): row i has ones at i-1, i, i+1 (mod n)."""
    a = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n)
    a[idx, idx] = 1.0
    a[idx, (idx + 1) % n] = 1.0
    a[idx, (idx - 1) % n] = 1.0
    return a


def step_mxu(grid: torch.Tensor, dtype: torch.dtype = torch.float32):
    """One generation with the neighbour sum as two circulant products.

    A @ G sums each cell's vertical 3-neighbourhood, (A @ G) @ A^T then
    the horizontal one: the 3x3 box. Counts are <= 9, exact in f32.
    """
    n = grid.shape[0]
    if grid.shape != (n, n):
        raise ValueError(f"step_mxu needs a square grid, got "
                         f"{tuple(grid.shape)}")
    a = torch.from_numpy(_circulant_111_np(n)).to(grid.device, dtype)
    g = grid.to(dtype)
    nb = (torch.matmul(torch.matmul(a, g), a.T) - g).to(torch.int32)
    return _rule(grid.to(torch.int32), nb).to(grid.dtype)


def multi_step(grid: torch.Tensor, k: int, backend: str = "mxu"):
    """Advance k generations with step_mxu ("mxu") or step_roll."""
    step = step_mxu if backend == "mxu" else step_roll
    for _ in range(int(k)):
        grid = step(grid)
    return grid


# ---------------------------------------------------------------------------
# Kernel B8 and its plain version
# ---------------------------------------------------------------------------


def multi_step_pallas_plain(g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B8: k generations of the f32 torus
    stencil on a [R, C] f32 grid of {0, 1}, as the TPU kernel computes
    them (rustexp_tpu/ops/gol_stencil.py:117-121): the vertical 3-sum,
    then the horizontal 3-sum of that minus the cell."""
    for _ in range(int(k)):
        rows = g + torch.roll(g, 1, 0) + torch.roll(g, -1, 0)
        nb = rows + torch.roll(rows, 1, 1) + torch.roll(rows, -1, 1) - g
        g = ((nb == 3.0) | ((g == 1.0) & (nb == 2.0))).to(torch.float32)
    return g


TILE = 32       # kernel B8's tile: TILE x TILE cells, one warp
MAX_HALO = 8    # generations per launch at most (the tile's halo)


class B8Plan(NamedTuple):
    halo: int      # generations per launch (the last may run fewer)
    launches: int  # grid launches of the call
    blocks: int    # one-warp blocks per launch


def _b8_plan(rows: int, cols: int, k: int) -> B8Plan:
    """Kernel B8's launches for k generations of a [rows, cols] grid.

    A launch steps `halo` generations on 32 x 32 tiles that overlap by
    `halo` cells on each side, so it covers the grid with
    ceil(rows / inner) x ceil(cols / inner) blocks, inner = 32 - 2 halo.
    The fewest launches of at most MAX_HALO generations, ceil(k / 8),
    share the generations evenly, which keeps the halo and so the tiles'
    overlap small: 20 generations are 3 launches of 7, 7 and 6, and 8 are
    one launch of 8. k = 0 launches nothing."""
    if k <= 0:
        return B8Plan(MAX_HALO, 0, 0)
    halo = -(-k // -(-k // MAX_HALO))
    inner = TILE - 2 * halo
    return B8Plan(halo, -(-k // halo),
                  -(-rows // inner) * -(-cols // inner))


@functools.cache
def _b8_kernel():
    lib = load_kernel_lib("gol_stencil")
    fn = lib.lib.gs_stencil
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib, fn


def multi_step_pallas_cuda(g: torch.Tensor, k: int) -> torch.Tensor:
    """Launch kernel B8 (csrc/gol_stencil.cu): k generations of the f32
    stencil on a contiguous [R, C] f32 CUDA tensor of 0s and 1s -> a new
    tensor.

    ``_b8_plan`` gives the generations per launch and the launches;
    ``multi_step_pallas_cuda.launches`` counts those grid launches.
    """
    if g.device.type != "cuda":
        raise ValueError(f"kernel B8 runs on CUDA tensors, got {g.device}")
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"kernel B8 needs a contiguous 2-D f32 grid, got "
                         f"{g.dtype} {tuple(g.shape)}")
    k = int(k)
    if k < 0:
        raise ValueError(f"k = {k} < 0")
    if k == 0:
        return g.clone()
    rows, cols = g.shape
    plan = _b8_plan(rows, cols, k)
    lib, fn = _b8_kernel()
    out = torch.empty_like(g)
    scratch = torch.empty_like(g) if plan.launches > 1 else out
    launched = ctypes.c_int(0)
    rc = fn(ptr(g), ptr(out), ptr(scratch), rows, cols, k, plan.halo,
            stream_ptr(g.device), ctypes.byref(launched))
    multi_step_pallas_cuda.launches += launched.value
    lib.check(rc, "kernel B8 (gs_stencil)")
    return out


multi_step_pallas_cuda.launches = 0


def multi_step_pallas(grid: torch.Tensor, k: int) -> torch.Tensor:
    """k generations of the fused f32 stencil, same dtype out.

    Raises ValueError past the JAX kernel's 640 x 1024-cell guard. CUDA
    tensors launch kernel B8, CPU tensors take its plain version.
    """
    rows_n, cols_n = grid.shape
    if rows_n * cols_n > MAX_PALLAS_CELLS:
        raise ValueError(f"{rows_n}x{cols_n} grid exceeds the fused stencil's "
                         f"{MAX_PALLAS_CELLS} cells (the JAX kernel's VMEM "
                         "guard); use multi_step or gol_bits")
    g = grid.to(torch.float32).contiguous()
    if g.device.type == "cuda":
        out = multi_step_pallas_cuda(g, k)
    elif g.device.type == "cpu":
        out = multi_step_pallas_plain(g, k)
    else:
        raise ValueError(f"no GoL stencil for device {g.device}")
    return out.to(grid.dtype)

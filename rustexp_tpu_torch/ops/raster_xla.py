"""Whole-frame G-buffer oracle: raster_gbuffer_xla.

Port of rustexp_tpu/ops/raster_xla.py. The JAX function folds the T
triangles over the whole frame in submission order, starting from the
clear (z 1.0, tid -1), and a triangle takes a pixel when it is valid,
the pixel is inside its edges and its AABB, and zi < z (strict). That
fold keeps, per pixel, the lexicographic minimum of (z, i) over the
clear and the covering triangles, with the clear ordered before every
triangle at equal z: a fragment at exactly z = 1.0 never beats the
clear, an equal later z never replaces an earlier one, a NaN depth never
wins, and -0.0 equals 0.0.

So this version evaluates each valid triangle only on the BLOCK_H x
BLOCK_W blocks its clipped AABB meets, batches of (triangle, block)
pairs at once, and takes the minimum of an int64 key ordered like
(z, i) with one scatter per batch; the key's low word is the winner's
index. The winner's z and barycentrics are then evaluated once per pixel
with the same formula on the same integers, so they carry the bits the
fold stores. This is plain PyTorch on the CPU and on the card alike: no
kernel lies behind it (kernel B3, ops/raster_bins.raster_gbuffer_pallas,
computes the same G-buffer over the bins).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ieee import lerp_2mad
from .raster_queue import _fdiv, _race_key

BLOCK_H = 8
BLOCK_W = 32
_BATCH_PX = 1 << 21  # pixel evaluations per batch


class GBuffer(NamedTuple):
    """Per-pixel visibility (rustexp_tpu/ops/raster_xla.py:26)."""

    z: torch.Tensor    # f32 [H, W] screen-space depth, cleared to 1.0
    tid: torch.Tensor  # i32 [H, W] winning triangle, -1 = background
    b: torch.Tensor    # f32 [H, W, 3] barycentrics (b0, b1, b2); vertex
    #                    weights (v0, v1, v2) <- (b1, b2, b0)


def _eval_tris(setup, t, xs, ys):
    """(covered, zi, b0, b1, b2) of triangles `t` at int32 pixels (xs, ys),
    shapes broadcasting: the JAX fold's per-triangle math
    (rustexp_tpu/ops/raster_xla.py:45-63), e2 from its own gradients."""
    xf = xs << 4
    yf = ys << 4
    e0, e1, e2 = (setup.A[t, k] * xf + setup.B[t, k] * yf + setup.C[t, k]
                  for k in range(3))
    inside = (e0 | e1 | e2) >= 0
    in_box = ((xs >= setup.min_x[t]) & (xs < setup.max_x[t])
              & (ys >= setup.min_y[t]) & (ys < setup.max_y[t]))
    inv_a2 = setup.inv_a2[t]
    # integer de-bias, then ONE f32 rounding at the product
    b0, b1, b2 = ((e - setup.bias[t, k].to(torch.int32)).to(torch.float32)
                  * inv_a2 for k, e in enumerate((e0, e1, e2)))
    zi = lerp_2mad(setup.z0[t], setup.z10[t], setup.z20[t], b2, b0)
    return inside & in_box, zi, b0, b1, b2


def raster_gbuffer_xla(setup, h: int, w: int) -> GBuffer:
    """Rasterize a stacked TriSetup to a G-buffer over the whole [h, w]
    frame, any size (rustexp_tpu/ops/raster_xla.py:35)."""
    dev = setup.A.device
    i32 = dict(dtype=torch.int32, device=dev)
    T = setup.A.shape[0]
    nby, nbx = -(-h // BLOCK_H), -(-w // BLOCK_W)
    wp = nbx * BLOCK_W

    # (triangle, block) pairs: every block each valid clipped AABB meets
    by0 = _fdiv(setup.min_y, BLOCK_H)
    bx0 = _fdiv(setup.min_x, BLOCK_W)
    ny = torch.where(setup.valid, _fdiv(setup.max_y - 1, BLOCK_H) - by0 + 1, 0)
    nx = torch.where(setup.valid, _fdiv(setup.max_x - 1, BLOCK_W) - bx0 + 1, 0)
    n = (ny * nx).long()
    tri = torch.repeat_interleave(torch.arange(T, **i32), n)
    k = (torch.arange(tri.shape[0], device=dev)
         - (torch.cumsum(n, 0) - n)[tri]).to(torch.int32)
    nx_t = nx[tri]
    pby = by0[tri] + torch.div(k, nx_t, rounding_mode="floor")
    pbx = bx0[tri] + k % nx_t

    iy = torch.arange(BLOCK_H, **i32)[None, :, None]
    ix = torch.arange(BLOCK_W, **i32)[None, None, :]
    clear = _race_key(torch.ones((), device=dev),
                      torch.zeros((), dtype=torch.int32, device=dev))
    best = torch.full((nby * BLOCK_H * wp,), int(clear), dtype=torch.int64,
                      device=dev)
    step = _BATCH_PX // (BLOCK_H * BLOCK_W)
    for lo in range(0, tri.shape[0], step):
        t = tri[lo:lo + step, None, None]
        ys = pby[lo:lo + step, None, None] * BLOCK_H + iy
        xs = pbx[lo:lo + step, None, None] * BLOCK_W + ix
        cov, zi, _, _, _ = _eval_tris(setup, t.long(), xs, ys)
        # a pixel off the frame lies outside every clipped AABB
        key = torch.where(cov, _race_key(zi, t + 1),
                          torch.iinfo(torch.int64).max)
        best.scatter_reduce_(0, (ys * wp + xs).reshape(-1).long(),
                             key.reshape(-1), reduce="amin")

    best = best.reshape(-1, wp)[:h, :w]
    won = best != clear
    tid = torch.where(won, (best & 0xFFFFFFFF) - 1, -1).to(torch.int32)
    ys, xs = won.nonzero(as_tuple=True)
    _, zi, b0, b1, b2 = _eval_tris(setup, tid[ys, xs].long(),
                                   xs.to(torch.int32), ys.to(torch.int32))
    z = torch.ones((h, w), dtype=torch.float32, device=dev)
    z[ys, xs] = zi
    b = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    b[ys, xs] = torch.stack([b0, b1, b2], dim=-1)
    return GBuffer(z=z, tid=tid, b=b)

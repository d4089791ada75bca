"""Block Barnes-Hut: the approximate N-body step, as plain torch ops.

Port of rustexp_tpu/ops/nbody_bh.py (the reference's Barnes-Hut quadtree,
nbody.rs:186-480, on a flat structure):

  1. sort the particles by Morton (Z-order) code, so equal-count blocks of
     the sorted array are spatial cells (kernel B6 at power-of-two N);
  2. per block, the centre of mass and the AABB;
  3. near field (exact): for each target block, the K(theta) source blocks
     with the smallest AABB distance over source diagonal (the s/d < theta
     opening test, blockwise; the block itself always first) get exact
     pair forces;
  4. far field: every other block contributes its monopole.

K(theta) = ceil(19 / theta^2), cross-calibrated in the JAX package
against the reference quadtree (its module docstring). The JAX package
wrote steps 2-4 as XLA ops outside any Pallas kernel; here they are torch
ops. theta == 0 is the brute-force route (the caller's choice). The step
returns the particles in Morton order.
"""

from __future__ import annotations

import torch

from .nbody_forces import EPS, euler, kill_runaway
from .sort_bitonic import sort_kv

# Route power-of-two sorts through kernel B6 (ops/sort_bitonic.py), as the
# JAX package routes them through its Pallas network; both equal the
# stable argsort route bit for bit.
USE_BITONIC_SORT = True


def _morton16(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Interleave two <= 15-bit int32s into a positive int32 Z-order code."""

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(ix) | (spread(iy) << 1)


def morton_codes(px, py, x1, x2, y1, y2, bits: int = 15) -> torch.Tensor:
    """Z-order codes for positions against an explicit bounding box."""
    scale = (1 << bits) - 1
    ix = ((px - x1) / (x2 - x1).clamp(min=1e-12) * scale).clamp(0, scale)
    iy = ((py - y1) / (y2 - y1).clamp(min=1e-12) * scale).clamp(0, scale)
    return _morton16(ix.to(torch.int32), iy.to(torch.int32))


def morton_sort(px, py, m, vx=None, vy=None, bits: int = 15):
    """The particle arrays [px, py, m(, vx, vy)] permuted into Z order.

    With USE_BITONIC_SORT, power-of-two counts >= 256 go through sort_kv
    (kernel B6 on the card, a radix sort that gathers the arrays once by
    its permutation); other counts take a stable argsort and gathers.
    Both give the same arrays bit for bit.
    """
    code = morton_codes(px, py, px.min(), px.max(), py.min(), py.max(), bits)
    vals = [px, py, m] + ([vx, vy] if vx is not None else [])
    n = px.shape[0]
    if USE_BITONIC_SORT and n >= 256 and n & (n - 1) == 0:
        return sort_kv(code, vals)[1]
    order = torch.argsort(code, stable=True)
    return [v[order] for v in vals]


def theta_to_k(theta: float, n_blocks: int) -> int:
    """Exact near-field blocks for theta: ~1/theta^2, 0.85 -> 27."""
    if theta <= 0:
        raise ValueError("theta == 0 is the brute-force route")
    return max(2, min(n_blocks, int(-(-19.0 // (theta * theta)))))


def near_block_indices(x1, x2, y1, y2, k_near: int, row0=None,
                       rows: int | None = None) -> torch.Tensor:
    """int64 [rows, k_near]: per target block, the k_near source blocks
    ranked first by squared AABB distance over the source block's squared
    diagonal, the block itself pinned first (ratio -1), ties to the lower
    index (stable argsort). `row0`/`rows` compute only the target rows
    row0 .. row0 + rows - 1, equal to those rows of the full table."""
    if rows is None:
        r0, rows = 0, x1.shape[0]
    else:
        r0 = int(row0)
    tx1, tx2 = x1[r0:r0 + rows], x2[r0:r0 + rows]
    ty1, ty2 = y1[r0:r0 + rows], y2[r0:r0 + rows]
    ddx = torch.maximum(x1[None, :] - tx2[:, None],
                        tx1[:, None] - x2[None, :]).clamp(min=0.0)
    ddy = torch.maximum(y1[None, :] - ty2[:, None],
                        ty1[:, None] - y2[None, :]).clamp(min=0.0)
    d2 = ddx * ddx + ddy * ddy
    wx, wy = x2 - x1, y2 - y1
    ratio = d2 / (wx * wx + wy * wy).clamp(min=1e-12)[None, :]
    rr = torch.arange(rows, device=x1.device)
    ratio[rr, r0 + rr] = -1.0
    return torch.argsort(ratio, dim=1, stable=True)[:, :k_near]


def block_aggregates(xb, yb, mb):
    """(msum, cx, cy) of [B, block] blocks: each block's mass and centre
    of mass (the mass floored at 1e-30 before its reciprocal)."""
    msum = mb.sum(dim=1)
    inv = torch.reciprocal(msum.clamp(min=1e-30))
    return msum, (xb * mb).sum(dim=1) * inv, (yb * mb).sum(dim=1) * inv


def forces_on_blocks(xt, yt, xb, yb, mb, msum, cx, cy, idx):
    """Forces per unit target mass on target blocks xt, yt [nt, block]
    from the sources xb, yb, mb [B, block] -> (fx, fy) [nt * block]:
    exact pairs with the source blocks idx [nt, K] names, the monopoles
    (msum, cx, cy) of every other block. One target block's sums have the
    same shapes whatever nt is, so a slice of the target blocks gets the
    same forces as the whole (the sharded step, parallel/nbody_shard.py)."""
    nt, block = xt.shape
    # near field: exact pairs, one gathered source block at a time; the
    # self pairs of the diagonal block add exactly zero (d = 0)
    fx = torch.zeros_like(xt)
    fy = torch.zeros_like(yt)
    for k in range(idx.shape[1]):
        src = idx[:, k]
        dx = xb[src][:, None, :] - xt[:, :, None]            # [nt, tgt, src]
        dy = yb[src][:, None, :] - yt[:, :, None]
        r = mb[src][:, None, :] / (dx * dx + dy * dy + EPS)
        fx = fx + (r * dx).sum(dim=2)
        fy = fy + (r * dy).sum(dim=2)

    # far field: the monopoles of every block outside the near set
    near = torch.zeros((nt, xb.shape[0]), dtype=torch.bool, device=xt.device)
    near[torch.arange(nt, device=xt.device)[:, None], idx] = True
    pxt, pyt = xt.reshape(-1), yt.reshape(-1)
    dxf = cx[None, :] - pxt[:, None]                                # [n, B]
    dyf = cy[None, :] - pyt[:, None]
    rf = msum[None, :] / (dxf * dxf + dyf * dyf + EPS)
    rf = torch.where(near.repeat_interleave(block, dim=0), 0.0, rf)
    return (fx.reshape(-1) + (rf * dxf).sum(dim=1),
            fy.reshape(-1) + (rf * dyf).sum(dim=1))


def forces_bh_sorted(px, py, m, block: int, k_near: int):
    """Forces on Morton-sorted particles: the k_near-block exact near field
    plus the block-monopole far field -> (fx, fy), with the target mass."""
    n = px.shape[0]
    nb = n // block
    if n % block or not 1 < k_near <= nb:
        raise ValueError(f"N={n}, block={block}, k_near={k_near}: need "
                         f"block | N and 1 < k_near <= N/block")
    xb, yb, mb = (a.reshape(nb, block) for a in (px, py, m))
    msum, cx, cy = block_aggregates(xb, yb, mb)
    idx = near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1), yb.amax(1),
                             k_near)                                # [B, K]
    fx, fy = forces_on_blocks(xb, yb, xb, yb, mb, msum, cx, cy, idx)
    return fx * m, fy * m


def step_bh(px, py, vx, vy, m, block: int, k_near: int, dt: float = 0.01):
    """One Euler step: Morton sort, block-BH forces, integrate, runaway
    kill (nbody.rs:460-471, after the position update). Returns
    (px, py, vx, vy, m) in Morton order."""
    px, py, m, vx, vy = morton_sort(px, py, m, vx, vy)
    fx, fy = forces_bh_sorted(px, py, m, block, k_near)
    px, py, vx, vy = euler(px, py, vx, vy, m, fx, fy, dt)
    vx, vy = kill_runaway(px, py, vx, vy)
    return px, py, vx, vy, m

"""Target-sharded N-body steps: brute force and block Barnes-Hut.

Port of rustexp_tpu/parallel/nbody_shard.py (:23-268). Each rank holds a
contiguous slice of the particles (the targets it integrates); sources
come from all-gathers.

* make_step: brute force with every source gathered, in plain torch ops
  as in JAX (kernel B5 is not on this path).
* make_step_bh: block Barnes-Hut. With distributed_sort (the default)
  each rank computes Morton codes against the MIN/MAX all-reduced box,
  sorts through sort_shard.dist_sort_stable (kernel B6 on the card for
  power-of-two chunks), all-gathers the sorted positions and masses and
  its blocks' aggregates, ranks the near blocks of its own target blocks
  and sums their forces with ops/nbody_bh.forces_on_blocks, the body the
  one-rank step_bh runs. distributed_sort=False gathers everything and
  sorts it on every rank (the replicated oracle). Either way the
  concatenated slices equal one-rank step_bh's particles bit for bit.

Both steps take and return (px, py, vx, vy, m) slices; mass passes
through, so the output feeds the next step.
"""

from __future__ import annotations

import torch

from ..ops.nbody_bh import (block_aggregates, forces_on_blocks, morton_codes,
                            morton_sort, near_block_indices, theta_to_k)
from ..ops.nbody_forces import EPS, euler, kill_runaway
from . import collectives as coll
from .sort_shard import dist_sort_stable


def make_step(group=None):
    """Brute-force Euler step of this rank's slice (:23): step(px, py, vx,
    vy, m, dt) -> (px, py, vx, vy, m). The particle count must divide
    over the ranks (every slice the same length)."""
    _, rank = coll.world(group)

    def step(px, py, vx, vy, m, dt: float):
        sx = coll.all_gather_cat(px, group)
        sy = coll.all_gather_cat(py, group)
        sm = coll.all_gather_cat(m, group)
        nloc = px.shape[0]
        gidx = rank * nloc + torch.arange(nloc, device=px.device)
        dx = sx[None, :] - px[:, None]
        dy = sy[None, :] - py[:, None]
        d2 = dx * dx + dy * dy + EPS
        f = (m[:, None] * sm[None, :]) / d2
        f = torch.where(gidx[:, None] == torch.arange(
            sx.shape[0], device=px.device)[None, :], 0.0, f)
        fx = (f * dx).sum(dim=1)
        fy = (f * dy).sum(dim=1)
        px, py, vx, vy = euler(px, py, vx, vy, m, fx, fy, dt)
        return px, py, vx, vy, m

    return step


def make_step_bh(group=None, block: int = 256, k_near: int | None = None,
                 distributed_sort: bool | None = None):
    """Block Barnes-Hut Euler step of this rank's slice (:67): step(px,
    py, vx, vy, m, dt) -> (px, py, vx, vy, m), this rank's slice of the
    Morton-sorted result. k_near defaults to theta_to_k(0.85) clamped to
    the block count; distributed_sort None means True (any group size).

    Raises when N is not a multiple of `block`, or when the blocks do not
    divide over the ranks (:143-152).
    """
    n_dev, dev = coll.world(group)
    if distributed_sort is None:
        distributed_sort = True
    if k_near is None:
        k_near = theta_to_k(0.85, 1 << 30)

    def step(pxs, pys, vxs, vys, ms, dt: float):
        n_loc = pxs.shape[0]
        n = n_loc * n_dev
        B = n // block
        nb_loc = B // n_dev
        if n % block:
            raise ValueError(f"N={n} not divisible by block={block}")
        if B % n_dev or nb_loc < 1:
            raise ValueError(
                f"B={B} blocks (N={n}/block={block}) must be a positive "
                f"multiple of n_dev={n_dev}: every device needs the same "
                f"whole number of target blocks. Grow N, shrink block, "
                f"or shrink the mesh axis.")
        kn = min(k_near, B)
        b0 = dev * nb_loc

        if distributed_sort:
            x1 = coll.pmin(pxs.min(), group)
            x2 = coll.pmax(pxs.max(), group)
            y1 = coll.pmin(pys.min(), group)
            y2 = coll.pmax(pys.max(), group)
            code = morton_codes(pxs, pys, x1, x2, y1, y2)
            _, _, (pxl, pyl, ml, vxl0, vyl0) = dist_sort_stable(
                code, [pxs, pys, ms, vxs, vys], group)
            px = coll.all_gather_cat(pxl, group)
            py = coll.all_gather_cat(pyl, group)
            m = coll.all_gather_cat(ml, group)
            xt = pxl.reshape(nb_loc, block)
            yt = pyl.reshape(nb_loc, block)
            # the aggregates of this rank's blocks, gathered as [B] vectors
            msum_l, cx_l, cy_l = block_aggregates(xt, yt,
                                                  ml.reshape(nb_loc, block))
            aggs = coll.all_gather_cat(torch.stack(
                [msum_l, cx_l, cy_l, xt.amin(1), xt.amax(1), yt.amin(1),
                 yt.amax(1)], dim=1), group)
            msum, cx, cy, bx1, bx2, by1, by2 = aggs.unbind(1)
            idx_loc = near_block_indices(bx1, bx2, by1, by2, kn,
                                         row0=b0, rows=nb_loc)
        else:
            px = coll.all_gather_cat(pxs, group)
            py = coll.all_gather_cat(pys, group)
            vx = coll.all_gather_cat(vxs, group)
            vy = coll.all_gather_cat(vys, group)
            m = coll.all_gather_cat(ms, group)
            px, py, m, vx, vy = morton_sort(px, py, m, vx, vy)
            xb, yb, mb = (a.reshape(B, block) for a in (px, py, m))
            msum, cx, cy = block_aggregates(xb, yb, mb)
            idx_loc = near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                         yb.amax(1), kn, row0=b0,
                                         rows=nb_loc)
            xt, yt = xb[b0:b0 + nb_loc], yb[b0:b0 + nb_loc]
            lo, hi = b0 * block, (b0 + nb_loc) * block
            ml, vxl0, vyl0 = m[lo:hi], vx[lo:hi], vy[lo:hi]

        fx, fy = forces_on_blocks(
            xt, yt, px.reshape(B, block), py.reshape(B, block),
            m.reshape(B, block), msum, cx, cy, idx_loc)
        pxl, pyl = xt.reshape(n_loc), yt.reshape(n_loc)
        pxl, pyl, vxl, vyl = euler(pxl, pyl, vxl0, vyl0, ml, fx * ml,
                                   fy * ml, dt)
        vxl, vyl = kill_runaway(pxl, pyl, vxl, vyl)
        return pxl, pyl, vxl, vyl, ml

    return step


def shard_particles(arrs, group=None) -> tuple:
    """This rank's slice of each particle array (:266)."""
    return tuple(coll.shard_rows(a, group).contiguous() for a in arrs)

"""Row-sharded Game of Life with halo exchange between ranks.

Port of rustexp_tpu/parallel/gol_shard.py (:38-164). Each rank holds a
contiguous block of rows of the [N, N] torus; the ring permutation of
collectives.permute brings it its neighbours' edge rows (the torus wrap
falls out of the ring), and the stencil runs locally. Three bodies, as in
JAX:

* "roll": one halo row each way every generation, plain torch ops (the
  oracle);
* "pallas": a k-row halo once, then k generations of
  gol_stencil.multi_step_pallas (kernel B8 on the card) on the padded
  block. The kernel's torus wrap is wrong at the padded edges, but a
  wrong value moves inward one row a generation, so k halo rows absorb k
  generations and the interior is exact;
* "bits": the same with the halo rounded up to 16 rows, packed 32 rows a
  word, through gol_bits.multi_step_packed (kernel B4 on the card). The
  port has no VMEM band model (ROADMAP C): B4 tiles any 32-row-aligned
  size itself, so the shard calls it directly where JAX goes through
  multi_step_packed_chain past its VMEM budget.

JAX's axis tuple ("dcn", "ici") is the group of all ranks here.
"""

from __future__ import annotations

import torch

from . import collectives as coll


def _rings(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def make_multi_step(group=None, k: int = 1, backend: str = "roll"):
    """A k-generation step of this rank's rows of a row-sharded [N, N]
    int grid (:38): step(local [r, N]) -> local [r, N], the same dtype.

    Raises for an unknown backend; the "pallas" and "bits" bodies raise
    when the halo exceeds the shard's rows, and "bits" when the rows are
    not a multiple of 32, as JAX's do.
    """
    n, _ = coll.world(group)
    fwd, bwd = _rings(n)

    def one_step(g):
        # halo_lo = last row of the previous rank; halo_hi = first of the next
        lo = coll.permute(g[-1:], fwd, group)
        hi = coll.permute(g[:1], bwd, group)
        p = torch.cat([lo, g, hi])
        r = g.shape[0]
        nb = torch.zeros_like(g)
        for dy in (0, 1, 2):
            rows = p[dy:dy + r]
            for dx in (-1, 0, 1):
                if dy == 1 and dx == 0:
                    continue
                nb = nb + torch.roll(rows, dx, 1)
        return ((nb == 3) | ((g == 1) & (nb == 2))).to(g.dtype)

    def step_roll(local):
        for _ in range(k):
            local = one_step(local)
        return local

    def step_pallas(local):
        from ..ops import gol_stencil

        r = local.shape[0]
        if k > r:
            raise ValueError(f"k={k} exceeds shard rows {r}; lower k")
        lo = coll.permute(local[-k:], fwd, group)
        hi = coll.permute(local[:k], bwd, group)
        out = gol_stencil.multi_step_pallas(torch.cat([lo, local, hi]), k)
        return out[k:k + r]

    def step_bits(local):
        from ..ops import gol_bits

        r = local.shape[0]
        # the padded block stays a whole number of 32-row words
        halo = -(-k // (gol_bits.BITS // 2)) * (gol_bits.BITS // 2)
        if r % gol_bits.BITS:
            raise ValueError(f"shard rows {r} not a multiple of "
                             f"{gol_bits.BITS}")
        if halo > r:
            raise ValueError(f"k={k} exceeds shard rows {r}; lower k")
        lo = coll.permute(local[-halo:], fwd, group)
        hi = coll.permute(local[:halo], bwd, group)
        packed = gol_bits.pack_rows(torch.cat([lo, local, hi]))
        out = gol_bits.multi_step_packed(packed, k)
        return gol_bits.unpack_rows(out, dtype=local.dtype)[halo:halo + r]

    bodies = {"roll": step_roll, "pallas": step_pallas, "bits": step_bits}
    if backend not in bodies:
        raise ValueError(f"backend {backend!r} not one of {sorted(bodies)}")
    return bodies[backend]


def shard_grid(grid: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of the [N, N] grid (:163)."""
    return coll.shard_rows(grid, group).contiguous()

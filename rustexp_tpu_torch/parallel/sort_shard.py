"""Distributed stable sort over the ranks of a group.

Port of rustexp_tpu/parallel/sort_shard.py (:50-136). Each rank holds one
contiguous chunk of n_loc elements of a logically concatenated array. The
chunk is sorted locally once, then compare-split stages exchange whole
chunks with a partner rank: a rank keeps the elementwise min (or max) of
its chunk against the partner's chunk reversed, which is exactly the n_loc
smallest (or largest) of the two (Batcher's bitonic split), and restores
its order with one merge. Every comparison is on (key, global position),
so the concatenated result equals a stable sort of the whole, bit for bit.

Power-of-two group sizes run the hypercube bitonic schedule (log D
(log D + 1) / 2 stages); any other size runs odd-even transposition (D
stages of neighbour splits). Power-of-two chunks of at least 256 sort and
merge through sort_bitonic (kernel B6 on the card, with the global
positions as its idx); other chunks take a stable (key, position) sort in
plain torch ops, as JAX takes jnp.lexsort.
"""

from __future__ import annotations

import torch

from ..ops.sort_bitonic import _substage_table, merge_kv, sort_kv_plain
from . import collectives as coll


def _pallas_ok(n: int) -> bool:
    return n >= 256 and (n & (n - 1)) == 0


def _sort(key, gidx, values):
    """The chunk in (key, gidx) order: the local sort and every merge.
    Power-of-two chunks of at least 256 take merge_kv (kernel B6 on the
    card), others a stable (key, gidx) sort in plain torch ops (JAX's
    jnp.lexsort)."""
    if _pallas_ok(key.shape[0]):
        return merge_kv(key, gidx, values)
    return sort_kv_plain(key, gidx, values)


def _exchange(key, gidx, values, perm, group):
    """The partner's (key, gidx, values) by one permute of the stacked
    int32 words (float payloads travel as their bits)."""
    words = torch.stack([key, gidx] + [
        v.view(torch.int32) if v.dtype == torch.float32 else v
        for v in values])
    got = coll.permute(words, perm, group)
    pv = [g.view(torch.float32) if v.dtype == torch.float32 else g
          for g, v in zip(got[2:], values)]
    return got[0], got[1], pv


def dist_sort_stable(key, values, group, n_dev: int | None = None):
    """Distributed stable sort by int32 `key` on this rank's chunk (:73).

    `key` and each of `values` (f32 or int32) are the rank's [n_loc] chunk
    of arrays concatenated in rank order. Returns (key, gidx, values):
    rank d holds the d-th chunk of the global stable-sort order, and
    `gidx` is each element's position in the original concatenation.
    """
    n, dev = coll.world(group)
    if n_dev is not None and n_dev != n:
        raise ValueError(f"n_dev={n_dev} on a group of {n} ranks")
    n_loc = key.shape[0]
    gidx = dev * n_loc + torch.arange(n_loc, dtype=torch.int32,
                                      device=key.device)
    key, gidx, values = _sort(key, gidx, list(values))
    if n == 1:
        return key, gidx, values

    def split_stage(perm, keep_min: bool, active: bool, key, gidx, values):
        # own ++ reversed(partner) is bitonic: {min(A_i, B_{n-1-i})} is
        # exactly the n_loc smallest of A and B
        pk, pg, pv = _exchange(key, gidx, values, perm, group)
        pk, pg, pv = pk.flip(0), pg.flip(0), [p.flip(0) for p in pv]
        if active:
            mine_first = (key < pk) | ((key == pk) & (gidx < pg))
            keep = mine_first if keep_min else ~mine_first
            key = torch.where(keep, key, pk)
            gidx = torch.where(keep, gidx, pg)
            values = [torch.where(keep, v, p) for v, p in zip(values, pv)]
        return _sort(key, gidx, values)

    if n & (n - 1) == 0:
        for j, k in zip(*_substage_table(n)):
            perm = [(d, d ^ j) for d in range(n)]
            # the low side (bit j clear) of an ascending run (bit k
            # clear) keeps the min half
            keep_min = ((dev & j) == 0) == ((dev & k) == 0)
            key, gidx, values = split_stage(perm, keep_min, True, key, gidx,
                                            values)
    else:
        for p in range(n):
            # phase p pairs ranks (2i + p % 2, 2i + p % 2 + 1); a rank
            # without a partner maps onto itself and keeps its chunk
            def pair_of(d):
                q = d + 1 if (d - p) % 2 == 0 else d - 1
                return q if 0 <= q < n else d
            perm = [(d, pair_of(d)) for d in range(n)]
            q = dev + 1 if (dev - p) % 2 == 0 else dev - 1
            key, gidx, values = split_stage(perm, dev < q, 0 <= q < n, key,
                                            gidx, values)
    return key, gidx, values

"""Flat-queue tile rasterizer: queue build, row gather and kernel B1.

Port of rustexp_tpu/ops/raster_queue.py. The screen is tiled 16x128;
each tile owns a contiguous, chunk-aligned segment of a flat queue of
(tile, triangle) pairs, and per-chunk scalars (ty, tx, first, count,
global ty) tell the raster kernel which tile a chunk of 128 pairs
belongs to. The queue STRUCTURE depends only on AABB/tile geometry, so
callers cache it across frames and re-gather the per-frame rows;
``check_queue_valid`` says when the camera moved too far.

Ported here: the three slot orders of ``build_queue``: ``"tri"``
(ascending triangle id within each tile, from one pair-key sort),
``"plane"`` (one sort of T keys and run tables shifted by each
enumeration plane) and ``"direct"`` (counts and slot ids read off the
coverage matrix), and ``"auto"``, which picks one by size as the JAX
package does (``resolve_order``). Every order shares one chunk layout,
in tile order. The kernels race on (z, triangle id), so a frame does not
depend on the order. ``row_stride``/``row_offset`` build one band of the
cyclic tile-row interleave (parallel/raster_shard.py): the queue covers
the global tile rows g with g % row_stride == row_offset, and the
chunks' global tile row tells the kernel where its pixels lie.

Kernel B1 (``csrc/raster_queue.cu``, replacing ``_queue_kernel``) runs
for CUDA tensors; ``raster_attrs_queue_plain`` is its plain PyTorch
version and serves CPU tensors. Kernel B7 (the same file and kernel
template with no planes, replacing ``_queue_kernel_zslot``) is B1's
depth race alone, for the deferred frame; ``raster_zslot_queue_plain``
is its plain version. Kernel T (the same file, ``queue_setup_cuda``) is
a frame's transform, triangle setup and channel table in one launch; its
plain version is raster/pipeline.py's chain then ``pack_table``. There is
no fallback between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import trace
from ..runtime import load_kernel_lib, ptr, stream_ptr
from .ieee import lerp_2mad, lerp_3w
from .raster_setup import TriSetupP

TILE_H = 16
TILE_W = 128
CHUNK = 128
ROW_MARGIN = 2  # rows of camera-drift headroom baked into Queue.rows/ylim
SHADE_W = 64    # fine compacted-shade block width (px); must divide TILE_W

# int channels per pair row: A0 A1 B0 B1 C0 C1 S min_x min_y max_x max_y tri
_I_CH = 12
_F_CH = 7  # bias0 bias1 bias2 z0 z10 z20 inv_a2  (+ 3*(n2+n3) attr channels)
INT32_MAX = 2**31 - 1
_PLAIN_BATCH_PX = 1 << 21  # pixel evaluations per batch of the plain B1
# (n2, n3) kernel B1 is instantiated for: V; P with the world position
# unprojected (ray_world); P with it interpolated (ray_world=False)
_B1_PLANES = ((4, 0), (4, 3), (4, 6))


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def choose_shade_w(occ_fine: int, occ_tile: int, *,
                   fine_w: int = SHADE_W, tile_w: int = TILE_W,
                   rebuild_per_frame: bool = False,
                   per_pixel: bool = True) -> int:
    """Compacted-shade block width for one scene config
    (rustexp_tpu/ops/raster_queue.py:131; thresholds from that file's
    A/B table). V modes never read the rows list: always tile_w."""
    if not per_pixel:
        return tile_w
    px_fine = occ_fine * fine_w
    px_tile = max(occ_tile * tile_w, 1)
    savings = 1.0 - px_fine / px_tile
    return fine_w if savings > (0.145 if rebuild_per_frame else 0.135) \
        else tile_w


class Queue(NamedTuple):
    """Camera-coherent raster work queue (rustexp_tpu/ops/raster_queue.py:172)."""

    ids: torch.Tensor          # i32 [S, chunk] triangle id per slot, -1 = empty
    scal: torch.Tensor         # i32 [S, 5] (ty, tx, first, count, global_ty)
    ranges: torch.Tensor       # i32 [T, 4] tile ranges (ty0, ty1, tx0, tx1)
    built_valid: torch.Tensor  # bool [T] front-facing at build
    overflow: torch.Tensor     # bool [] structure truncated
    rows: torch.Tensor         # i32 [Rc] occupied shade-block ids; pad = h*(w//shade_w)
    ylim: torch.Tensor         # i32 [T, 2] y-extent (with margin) rows was built from
    xlim: torch.Tensor         # i32 [T, 2] x-extent (with margin)
    shade_w: int               # block width the rows list was built at
    order: str = "tri"         # slot order the build resolved ("tri",
    #                            "plane" or "direct"; "unknown" when carried)


def tile_ranges(setup):
    """Inclusive tile index ranges covered by each clipped pixel AABB."""
    ty0 = _fdiv(setup.min_y, TILE_H)
    ty1 = _fdiv(setup.max_y - 1, TILE_H)
    tx0 = _fdiv(setup.min_x, TILE_W)
    tx1 = _fdiv(setup.max_x - 1, TILE_W)
    return ty0, ty1, tx0, tx1


def resolve_order(order: str, T: int, s_cap: int, m_y: int, m_x: int,
                  n_tiles: int, chunk: int = CHUNK) -> str:
    """The slot order build_queue runs for `order` on a mesh of T
    triangles at caps (s_cap, m_y, m_x) over n_tiles tiles
    (rustexp_tpu/ops/raster_queue.py:296-314).

    "auto" takes "direct" for tiny meshes (T <= 64, or T <= 2048 while the
    [T, s_cap, chunk] rank match stays under 2^25), else "plane" from 2,048
    triangles while its run table R = O(m_y^2 m_x^2) stays small, else
    "tri". A plane build whose keys group * T + tri would not fit int32
    falls back to "tri". The thresholds are the JAX package's TPU v5e A/Bs
    of the moving frame, kept for parity; the card's are not measured.
    """
    if order not in ("auto", "tri", "plane", "direct"):
        raise ValueError(f"unknown queue order {order!r}")
    if order == "auto":
        r_est = (m_y * (m_y + 1) // 2) * (m_x * (m_x + 1) // 2)
        if T <= 64 or (T <= 2048 and T * s_cap * chunk <= 2 ** 25):
            order = "direct"
        else:
            order = "plane" if (T >= 2048 and r_est <= 512) else "tri"
    if order == "plane" and n_tiles * (m_y * m_x) * (T + 1) >= 2 ** 31:
        order = "tri"
    return order


@functools.cache
def _plane_run_index(nty_g: int, ntx: int, m_y: int, m_x: int,
                     device: torch.device, row_stride: int = 1,
                     row_offset: int = 0) -> torch.Tensor:
    """int64 [n_tiles, R] on `device`: per local tile and run, the flat
    index into the [nty_g * ntx * C] global group facts of the run's
    source group, or nty_g * ntx * C where the source tile is off the
    frame.

    A run (dy, dx, sy, sx) of tile (gy, tx), gy the global tile row
    ty * row_stride + row_offset of local row ty, is the group of base
    tile (gy - dy, tx - dx) at span class (sy - 1) * m_x + (sx - 1); runs
    are flattened in (dy, dx, sy, sx) order, the slot order of a plane
    queue (rustexp_tpu/ops/raster_queue.py:209-221, 386-411).
    """
    C = m_y * m_x
    runs = [(dy, dx, (sy - 1) * m_x + (sx - 1))
            for dy in range(m_y) for dx in range(m_x)
            for sy in range(dy + 1, m_y + 1) for sx in range(dx + 1, m_x + 1)]
    off = nty_g * ntx * C
    rows = range(row_offset, nty_g, row_stride)
    return trace.upload("run_index", torch.tensor(
        [[((gy - dy) * ntx + (tx - dx)) * C + cls
          if gy >= dy and tx >= dx else off for dy, dx, cls in runs]
         for gy in rows for tx in range(ntx)],
        dtype=torch.int64), device)


def build_queue(setup, h: int, w: int, *, s_cap: int, m_y: int, m_x: int,
                t_cap: int | None = None, order: str = "auto",
                row_stride: int = 1, row_offset: int = 0,
                shade_w: int = SHADE_W) -> Queue:
    """Construct the flat queue from a frame's setup.

    rustexp_tpu/ops/raster_queue.py:223: `order` resolves by
    resolve_order; then the per-tile counts and slot ids of that order
    (tri: the pair-key sort :415-450 and slot gather :522-528; plane: one
    sort of T keys, the group histogram and the shifted run tables
    :343-414 and :501-521; direct: the coverage matrix's ranks :325-342
    and :486-500), the chunk layout every order shares (:452-483) and the
    shade-block rows list (:535-604). JAX's f32 one-hot contractions are
    integer sums or searches here, exact at any matmul precision. Nothing
    is read back to the host.

    `row_stride`/`row_offset` (:283-290) build one band of the cyclic
    tile-row interleave: the queue covers the global tile rows g with
    g % row_stride == row_offset as local tile row g // row_stride.
    `setup` is then the untranslated whole-frame setup and `h` the whole
    frame's height; the chunks carry their global tile row (scal column
    4), and `ranges`/`ylim` stay global, so check_queue_valid does not
    depend on the interleave.
    """
    dev = setup.valid.device
    i32 = dict(dtype=torch.int32, device=dev)
    nty_g, ntx = h // TILE_H, w // TILE_W        # the whole frame's tiles
    if nty_g % row_stride:
        raise ValueError(
            f"{nty_g} tile rows not divisible by row_stride={row_stride}")
    if not 0 <= row_offset < row_stride:
        raise ValueError(f"row_offset={row_offset} outside [0, "
                         f"{row_stride})")
    nty = nty_g // row_stride                    # the local tile rows
    n_tiles = nty * ntx
    T = setup.valid.shape[0]
    valid = setup.valid
    order = resolve_order(order, T, s_cap, m_y, m_x, nty_g * ntx)

    ty0, ty1, tx0, tx1 = tile_ranges(setup)
    span_y = ty1 - ty0 + 1
    span_x = tx1 - tx0 + 1

    # local tile rows compare at their global indices
    ty_ar = torch.arange(nty, **i32) * row_stride + row_offset
    tx_ar = torch.arange(ntx, **i32)
    cov_y = (ty_ar[None, :] >= ty0[:, None]) & (ty_ar[None, :] <= ty1[:, None])
    cov_x = (tx_ar[None, :] >= tx0[:, None]) & (tx_ar[None, :] <= tx1[:, None])
    cov = (cov_y[:, :, None] & cov_x[:, None, :]
           & valid[:, None, None]).reshape(T, n_tiles)

    if order == "direct":
        # A tile's segment is its covering triangles (within the m_y x m_x
        # enumeration) in ascending id order; a triangle's slot in it is
        # its exclusive rank down the coverage matrix.
        win_y = cov_y & (ty_ar[None, :] - ty0[:, None] < m_y)
        win_x = cov_x & (tx_ar[None, :] - tx0[:, None] < m_x)
        cov_m = (win_y[:, :, None] & win_x[:, None, :]
                 & valid[:, None, None]).reshape(T, n_tiles)
        cov_mi = cov_m.to(torch.int32)
        rank = torch.cumsum(cov_mi, 0, dtype=torch.int32) - cov_mi
        counts = cov_mi.sum(0, dtype=torch.int32)
    elif order == "plane":
        # Plane (dy, dx) maps triangle i to tile base(i) + (dy, dx), a
        # constant shift, so one ascending sort of the T keys (base tile,
        # span class, tri) orders every plane; a tile's segment is the
        # concatenation of <= R runs of that one sorted array. The keys
        # and groups cover the whole frame; only the run table picks the
        # band's tiles.
        C = m_y * m_x
        sy = span_y.clamp(1, m_y)
        sx = span_x.clamp(1, m_x)
        group = (ty0 * ntx + tx0) * C + (sy - 1) * m_x + (sx - 1)
        tri = torch.arange(T, **i32)
        n_g = nty_g * ntx * C
        # keys < n_g * T < 2^31 (resolve_order's guard)
        skey = torch.sort(torch.where(valid, group * T + tri,
                                      n_g * T)).values
        stri = skey % T
        # Group lengths and starts; entry n_g is an empty group that runs
        # from off-frame source tiles read (length 0: no rank selects
        # them, so their start is never used).
        glen = torch.zeros(n_g + 1, **i32).scatter_add_(
            0, torch.where(valid, group, n_g).long(), valid.to(torch.int32))
        gstart = torch.cumsum(glen, 0, dtype=torch.int32) - glen
        run_idx = _plane_run_index(nty_g, ntx, m_y, m_x, dev, row_stride,
                                   row_offset)
        run_len = glen[run_idx]                                 # [nT, R]
        run_start = gstart[run_idx]
        counts = run_len.sum(1, dtype=torch.int32)
    else:
        # Pair enumeration per (triangle, dy, dx); tiles beyond the m_y/m_x
        # spans are not enumerated (overflow flag below). Keys sort by
        # (tile, tri): ascending triangle id within a tile.
        dy = torch.arange(m_y, **i32)
        dx = torch.arange(m_x, **i32)
        t_ty = ty0[:, None, None] + dy[None, :, None]
        t_tx = tx0[:, None, None] + dx[None, None, :]
        ok = (valid[:, None, None]
              & (dy[None, :, None] < span_y[:, None, None])
              & (dx[None, None, :] < span_x[:, None, None])
              & (t_ty % row_stride == row_offset))   # the band's rows only
        tile_id = _fdiv(t_ty, row_stride) * ntx + t_tx         # local
        tri_id = torch.arange(T, **i32)[:, None, None].expand_as(tile_id)
        big = n_tiles * T
        skey = torch.sort(torch.where(ok, tile_id * T + tri_id, big)
                          .reshape(-1)).values
        bounds = torch.searchsorted(
            skey, torch.arange(n_tiles + 1, **i32) * T, out_int32=True)
        counts = bounds[1:] - bounds[:-1]

    # Chunk-aligned segment layout; pad chunks go to the extra tile row
    # ty = nty, which the raster wrappers slice off. Column 4 is the
    # global tile row, at which the kernels evaluate the edges.
    cpt = _fdiv(counts + (CHUNK - 1), CHUNK)
    starts = torch.cumsum(cpt, 0, dtype=torch.int32) - cpt
    total_chunks = cpt.sum()

    cs = torch.arange(s_cap, **i32)
    in_tile = ((cs[None, :] >= starts[:, None])
               & (cs[None, :] < (starts + cpt)[:, None]))
    tile_of = torch.argmax(in_tile.to(torch.int32), dim=0).to(torch.int32)
    chunk_live = in_tile.any(dim=0)
    k_of = cs - starts[tile_of]
    first = (chunk_live & (k_of == 0)) | ~chunk_live
    cnt = (counts[tile_of] - k_of * CHUNK).clamp(0, CHUNK)
    cnt = torch.where(chunk_live, cnt, 0)
    ty = torch.where(chunk_live, _fdiv(tile_of, ntx), nty)
    tx = torch.where(chunk_live, tile_of % ntx, 0)
    scal = torch.stack([ty, tx, first.to(torch.int32), cnt,
                        ty * row_stride + row_offset], dim=1)

    lane = torch.arange(CHUNK, **i32)
    slot_ok = lane[None, :] < cnt[:, None]
    if order == "direct":
        # Slot (s, j) holds the triangle whose rank in the tile is
        # k_of[s] * CHUNK + j (JAX's rank-match contraction): each covering
        # triangle writes its id there; ranks in a tile are distinct, and
        # every other (triangle, chunk) writes one spare word.
        j = rank[:, tile_of] - (k_of * CHUNK)[None, :]          # [T, S]
        hit = cov_m[:, tile_of] & (j >= 0) & (j < CHUNK)
        dst = torch.where(hit, cs[None, :] * CHUNK + j, s_cap * CHUNK)
        src = torch.zeros(s_cap * CHUNK + 1, **i32).scatter_(
            0, dst.reshape(-1).long(),
            torch.arange(T, **i32)[:, None].expand(T, s_cap).reshape(-1))
        ids = torch.where(slot_ok, src[:-1].reshape(s_cap, CHUNK), -1)
    elif order == "plane":
        # Rank k of the tile's segment lies in run r iff exclusive-cum[r] <=
        # k < inclusive-cum[r]: the first run whose inclusive sum exceeds k
        # (JAX's run-membership contraction). Its source position is
        # run_start[r] + k - exclusive-cum[r].
        kk = (k_of * CHUNK)[:, None] + lane[None, :]            # [S, chunk]
        rlen_t = run_len[tile_of]                               # [S, R]
        rinc_t = torch.cumsum(rlen_t, 1, dtype=torch.int32)
        r = torch.searchsorted(rinc_t, kk, right=True)
        b = torch.cat([run_start[tile_of] - (rinc_t - rlen_t),
                       torch.zeros((s_cap, 1), **i32)], dim=1)
        pos = b.gather(1, r) + kk
        src = stri[pos.clamp(0, T - 1).reshape(-1)]
        ids = torch.where(slot_ok, src.reshape(s_cap, CHUNK), -1)
    else:
        pos = (bounds[tile_of] + k_of * CHUNK)[:, None] + lane[None, :]
        src = skey[pos.clamp(0, skey.shape[0] - 1).reshape(-1)]
        ids = torch.where(slot_ok, src.reshape(s_cap, CHUNK) % T, -1)

    overflow = ((total_chunks > s_cap)
                | (valid & ((span_y > m_y) | (span_x > m_x))).any())

    # Occupied shade-block list: a block (one shade_w-wide span of one
    # row) can hold coverage only inside the ROW_MARGIN-expanded extents
    # of the pair AABBs landing in its tile. Block ids are local; the
    # test runs at the block's global pixel row.
    nsx = w // shade_w
    spt = TILE_W // shade_w
    n_rb = nty * TILE_H * nsx
    if t_cap is None or t_cap > n_rb:
        t_cap = n_rb
    ymin_tri = (setup.min_y - ROW_MARGIN).clamp(min=0)
    ymax_tri = (setup.max_y + ROW_MARGIN).clamp(max=h)
    ymin_t = torch.where(cov, ymin_tri[:, None], h).amin(dim=0)
    ymax_t = torch.where(cov, ymax_tri[:, None], 0).amax(dim=0)
    rbid = torch.arange(n_rb, **i32)
    rb_tile = _fdiv(_fdiv(rbid, nsx), TILE_H) * ntx + _fdiv(rbid % nsx, spt)
    rb_ly = _fdiv(rbid, nsx)
    rb_y = ((_fdiv(rb_ly, TILE_H) * row_stride + row_offset) * TILE_H
            + rb_ly % TILE_H)
    occ_rb = ((counts[rb_tile] > 0)
              & (rb_y >= ymin_t[rb_tile]) & (rb_y < ymax_t[rb_tile]))
    if shade_w == TILE_W:
        # a block's x-span is its tile column: tile containment bounds x
        xmin_tri = torch.zeros_like(ymin_tri)
        xmax_tri = torch.full_like(ymax_tri, w)
    else:
        xmin_tri = (setup.min_x - ROW_MARGIN).clamp(min=0)
        xmax_tri = (setup.max_x + ROW_MARGIN).clamp(max=w)
        xmin_t = torch.where(cov, xmin_tri[:, None], w).amin(dim=0)
        xmax_t = torch.where(cov, xmax_tri[:, None], 0).amax(dim=0)
        rb_x0 = (rbid % nsx) * shade_w
        occ_rb = (occ_rb
                  & (rb_x0 < xmax_t[rb_tile])
                  & (rb_x0 + shade_w > xmin_t[rb_tile]))
    occ_n = occ_rb.sum()
    occ_order = torch.argsort(torch.where(occ_rb, rbid, rbid + n_rb))[:t_cap]
    rows = torch.where(torch.arange(t_cap, **i32) < occ_n,
                       occ_order.to(torch.int32), n_rb)
    overflow = overflow | (occ_n > t_cap)

    return Queue(ids=ids, scal=scal,
                 ranges=torch.stack([ty0, ty1, tx0, tx1], dim=1),
                 built_valid=valid, overflow=overflow, rows=rows,
                 ylim=torch.stack([ymin_tri, ymax_tri], dim=1),
                 xlim=torch.stack([xmin_tri, xmax_tri], dim=1),
                 shade_w=int(shade_w), order=order)


def check_queue_valid(queue: Queue, setup) -> torch.Tensor:
    """bool []: is the cached structure still a superset of this frame's
    coverage? (rustexp_tpu/ops/raster_queue.py:607)"""
    ty0, ty1, tx0, tx1 = tile_ranges(setup)
    r = queue.ranges
    inside = ((ty0 >= r[:, 0]) & (ty1 <= r[:, 1])
              & (tx0 >= r[:, 2]) & (tx1 <= r[:, 3])
              & (setup.min_y >= queue.ylim[:, 0])
              & (setup.max_y <= queue.ylim[:, 1])
              & (setup.min_x >= queue.xlim[:, 0])
              & (setup.max_x <= queue.xlim[:, 1]))
    ok = torch.where(setup.valid, inside & queue.built_valid, True).all()
    return ok & ~queue.overflow


def pack_table(setup, extra_f) -> torch.Tensor:
    """Planar channel table f32 [T + 1, CH] (rustexp_tpu/ops/raster_queue.py:632).

    Int channels are bitcast to f32 so one row gather fetches everything;
    row T is the all-zero empty-slot sentinel (its AABB admits no pixel).
    """
    S = setup.C0 + setup.C1 + setup.C2
    tri = torch.arange(setup.C0.shape[0], dtype=torch.int32,
                       device=setup.C0.device)
    ichans = [setup.A0, setup.A1, setup.B0, setup.B1, setup.C0, setup.C1,
              S, setup.min_x, setup.min_y, setup.max_x, setup.max_y, tri]
    fchans = [setup.bias0, setup.bias1, setup.bias2, setup.z0, setup.z10,
              setup.z20, setup.inv_a2, *extra_f]
    chans = [c.view(torch.float32) for c in ichans] + fchans
    tab = torch.stack(chans, dim=1)
    return torch.cat([tab, tab.new_zeros((1, tab.shape[1]))])


def _channel_table(setup, extra_f) -> torch.Tensor:
    """The [T + 1, CH] table of `setup` and `extra_f`: the one kernel T
    wrote beside the setup (its attribute columns are the `extra_f` that
    queue_attr_channels returned with it), else pack_table's."""
    tab = setup.table
    if tab is not None and len(extra_f) == tab.shape[1] - _I_CH - _F_CH:
        return tab
    return pack_table(setup, extra_f)


def gather_rows(queue: Queue, tabT: torch.Tensor, return_flat: bool = False):
    """One row gather per queue slot -> (rows_i i32 [S, 12, chunk],
    rows_f f32 [S, F, chunk]), channel-major per chunk
    (rustexp_tpu/ops/raster_queue.py:659).

    With return_flat, also rows_flat f32 [S*chunk + 1, CH]: the gathered
    rows indexed by queue slot (int channels bitcast), with an all-zero
    sentinel row last, from which the deferred shade re-fetches a
    winning pair's channels.
    """
    s_cap, chunk = queue.ids.shape
    sentinel = tabT.shape[0] - 1
    flat = torch.where(queue.ids < 0, sentinel, queue.ids).reshape(-1)
    gathered = tabT[flat]
    rows = gathered.reshape(s_cap, chunk, -1).permute(0, 2, 1)
    rows_i = rows[:, :_I_CH].contiguous().view(torch.int32)
    rows_f = rows[:, _I_CH:].contiguous()
    if return_flat:
        return rows_i, rows_f, torch.cat([gathered, tabT[-1:]])
    return rows_i, rows_f


# ---------------------------------------------------------------------------
# Kernels B1 and B7 and their plain versions
# ---------------------------------------------------------------------------


def _barycentrics(ci, cf, xs, ys):
    """(covered, b0, b1, b2) of pair records at pixels: the 28.4 edge
    functions (e2 = S - e0 - e1), the sign-OR inside and AABB tests, and
    the barycentrics f32(e - bias) * inv_a2
    (rustexp_tpu/ops/raster_queue.py:741-754).

    ``ci``/``cf`` index the int/float channels on dim 0; the rest of their
    shape broadcasts against the int32 pixel coordinates ``xs``/``ys``.
    """
    xf = xs << 4
    yf = ys << 4
    e0 = ci[0] * xf + ci[2] * yf + ci[4]   # int32, wraps like XLA's
    e1 = ci[1] * xf + ci[3] * yf + ci[5]
    e2 = ci[6] - e0 - e1
    inside = (e0 | e1 | e2) >= 0
    in_box = (xs >= ci[7]) & (ys >= ci[8]) & (xs < ci[9]) & (ys < ci[10])
    inv_a2 = cf[6]
    # integer de-bias, then ONE f32 rounding at the product
    b0 = (e0 - cf[0].to(torch.int32)).to(torch.float32) * inv_a2
    b1 = (e1 - cf[1].to(torch.int32)).to(torch.float32) * inv_a2
    b2 = (e2 - cf[2].to(torch.int32)).to(torch.float32) * inv_a2
    return inside & in_box, b0, b1, b2


def _eval_pairs(ci, cf, xs, ys, n2: int, n3: int, planes: bool):
    """Depth (and attribute planes) of pairs at pixels — _queue_kernel's
    per-pair math (rustexp_tpu/ops/raster_queue.py:726-775), with
    _barycentrics' shapes. Returns (zm, lins): zm is +inf outside the
    triangle or its AABB.
    """
    covered, b0, b1, b2 = _barycentrics(ci, cf, xs, ys)
    zi = lerp_2mad(cf[3], cf[4], cf[5], b2, b0)
    zm = torch.where(covered, zi, torch.inf)
    if not planes:
        return zm, None
    lins = [lerp_2mad(cf[_F_CH + a], cf[_F_CH + n2 + a],
                      cf[_F_CH + 2 * n2 + a], b2, b0) for a in range(n2)]
    off = _F_CH + 3 * n2
    lins += [lerp_3w(cf[off + a], cf[off + n3 + a], cf[off + 2 * n3 + a],
                     b1, b2, b0) for a in range(n3)]
    return zm, lins


def _race_key(zm: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """int64 key whose order is the depth race's: lexicographic (z, tri).

    -0.0 and 0.0 compare equal in the race, so z is canonicalised before
    its bits are made order-preserving; a NaN depth never wins (key max).
    """
    bits = (zm + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ INT32_MAX, bits).to(torch.int64)
    key = (ordered << 32) | tri.to(torch.int64)
    return torch.where(torch.isnan(zm), torch.iinfo(torch.int64).max, key)


def _queue_race(scal, rows_i, rows_f, h: int, w: int):
    """The depth race of kernels B1 and B7, plain: each pixel's winning
    pair over h + TILE_H rows.

    JAX's kernels walk each tile's pairs in queue order and keep a
    pixel's fragment when (z, tri) < (z_cur, tri_cur), starting from the
    clear (1.0, INT32_MAX). That is the lexicographic minimum of (z, tri,
    slot) over the tile's pairs and the clear, so this version evaluates
    batches of pairs as one tensor, takes the minimum of (z, tri) with a
    scatter, and finds the lowest winning slot in a second pass. Returns
    (pix, ci, cf, xs, ys, slot): the won pixels (flat indices), the
    winners' int and float channels ([12, n], [F, n]), their int32 pixel
    coordinates and their queue slots.
    """
    dev = rows_f.device
    s_cap, _, chunk = rows_i.shape
    hp = h + TILE_H
    lane = torch.arange(chunk, device=dev)
    c_idx, p_idx = (lane[None, :] < scal[:, 3:4]).nonzero(as_tuple=True)
    pi = rows_i[c_idx, :, p_idx]                     # [P, 12]
    pf = rows_f[c_idx, :, p_idx]                     # [P, F]
    ty, tx, gty = scal[c_idx, 0], scal[c_idx, 1], scal[c_idx, 4]
    iy = torch.arange(TILE_H, dtype=torch.int32, device=dev)
    ix = torch.arange(TILE_W, dtype=torch.int32, device=dev)
    n_pairs = c_idx.shape[0]
    step = _PLAIN_BATCH_PX // (TILE_H * TILE_W)

    def batch(lo: int, hi: int):
        xs = (tx[lo:hi] * TILE_W)[:, None, None] + ix[None, None, :]
        ys = (gty[lo:hi] * TILE_H)[:, None, None] + iy[None, :, None]
        zm, _ = _eval_pairs(pi[lo:hi].T[:, :, None, None],
                            pf[lo:hi].T[:, :, None, None], xs, ys,
                            0, 0, planes=False)
        key = _race_key(zm, pi[lo:hi, 11][:, None, None])
        out_y = (ty[lo:hi] * TILE_H)[:, None, None] + iy[None, :, None]
        idx = (out_y * w + xs).to(torch.int64)
        return key.reshape(-1), idx.reshape(-1)

    clear = _race_key(torch.ones((), device=dev),
                      torch.tensor(INT32_MAX, device=dev))
    best = torch.full((hp * w,), int(clear), dtype=torch.int64, device=dev)
    for lo in range(0, n_pairs, step):
        key, idx = batch(lo, lo + step)
        best.scatter_reduce_(0, idx, key, reduce="amin")
    # A triangle may sit in more than one slot of a tile, and its copies
    # tie on (z, tri): the kernels' walk keeps the first, so among the
    # pairs that reach the minimum the lowest one (in slot order) wins.
    winner = torch.full((hp * w,), n_pairs, dtype=torch.int64, device=dev)
    for lo in range(0, n_pairs, step):
        key, idx = batch(lo, lo + step)
        pair = torch.arange(lo, min(lo + step, n_pairs), device=dev)
        pair = pair[:, None].expand(-1, TILE_H * TILE_W).reshape(-1)
        winner.scatter_reduce_(
            0, idx, torch.where(key == best[idx], pair, n_pairs),
            reduce="amin")

    pix = (winner < n_pairs).nonzero().squeeze(1)
    wp = winner[pix]
    xs = (pix % w).to(torch.int32)
    ys = gty[wp] * TILE_H + (_fdiv(pix, w) % TILE_H).to(torch.int32)
    slot = (c_idx * chunk + p_idx)[wp].to(torch.int32)
    return pix, pi[wp].T, pf[wp].T, xs, ys, slot


def _zslot_frame(pix, zm, slot, h: int, w: int):
    """z (clear 1.0) and slot (-1) over h + TILE_H rows from the won pixels."""
    hp = h + TILE_H
    z = torch.ones(hp * w, dtype=torch.float32, device=zm.device)
    z[pix] = zm
    slots = torch.full((hp * w,), -1, dtype=torch.int32, device=zm.device)
    slots[pix] = slot
    return z.reshape(hp, w), slots.reshape(hp, w)


def raster_attrs_queue_plain(scal, rows_i, rows_f, n2: int, n3: int,
                             h: int, w: int):
    """Plain PyTorch version of kernel B1 -> (z, slot, lin) over h + TILE_H rows.

    _queue_race finds each pixel's winning pair; only the winner's planes
    are then evaluated (same formula, same bits as a kernel that carries
    them through the race). Pixels nobody wins keep the clear: z 1.0,
    slot -1, planes 0.
    """
    pix, ci, cf, xs, ys, slot = _queue_race(scal, rows_i, rows_f, h, w)
    zm, lins = _eval_pairs(ci, cf, xs, ys, n2, n3, planes=True)
    z, slots = _zslot_frame(pix, zm, slot, h, w)
    hp = h + TILE_H
    lin = torch.zeros((n2 + n3, hp * w), dtype=torch.float32,
                      device=rows_f.device)
    lin[:, pix] = torch.stack(lins)
    return z, slots, lin.reshape(n2 + n3, hp, w)


def raster_zslot_queue_plain(scal, rows_i, rows_f, h: int, w: int):
    """Plain PyTorch version of kernel B7, B1's race without the planes
    -> (z, slot) over h + TILE_H rows. Pixels nobody wins: z 1.0, slot -1.
    """
    pix, ci, cf, xs, ys, slot = _queue_race(scal, rows_i, rows_f, h, w)
    zm, _ = _eval_pairs(ci, cf, xs, ys, 0, 0, planes=False)
    return _zslot_frame(pix, zm, slot, h, w)


@functools.cache
def _b1_kernel():
    """The built kernel library and its C entry, typed once."""
    lib = load_kernel_lib("raster_queue")
    fn = lib.lib.rq_queue_raster
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return lib, fn


def raster_attrs_queue_cuda(scal, rows_i, rows_f, n2: int, n3: int,
                            h: int, w: int):
    """Launch kernel B1 (csrc/raster_queue.cu) -> (z, slot, lin) over
    h + TILE_H rows, every word written by the one grid: where no pair
    won, z 1.0, slot -1 and planes 0, as the plain version gives. The
    kernel finds a tile's chunks by a search, so scal must hold them in
    tile order (ty * ntx + tx ascending), as build_queue lays them out.

    ``raster_attrs_queue_cuda.launches`` counts the grid launches.
    """
    dev = rows_f.device
    s_cap, n_ich, chunk = rows_i.shape
    npl = n2 + n3
    for name, t, dt in (("scal", scal, torch.int32),
                        ("rows_i", rows_i, torch.int32),
                        ("rows_f", rows_f, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"kernel B1 runs on CUDA tensors, got {dev}")
    if (n2, n3) not in _B1_PLANES:
        raise ValueError(f"kernel B1 is built for (n2, n3) in {_B1_PLANES}, "
                         f"got {(n2, n3)}")
    if (scal.shape != (s_cap, 5) or n_ich != _I_CH
            or rows_f.shape != (s_cap, _F_CH + 3 * npl, chunk)):
        raise ValueError(f"bad queue shapes: scal {tuple(scal.shape)}, "
                         f"rows_i {tuple(rows_i.shape)}, "
                         f"rows_f {tuple(rows_f.shape)} for n2={n2}, n3={n3}")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by {TILE_H}x{TILE_W}")
    lib, fn = _b1_kernel()
    hp = h + TILE_H
    z = torch.empty((hp, w), dtype=torch.float32, device=dev)
    slot = torch.empty((hp, w), dtype=torch.int32, device=dev)
    lin = torch.empty((npl, hp, w), dtype=torch.float32, device=dev)
    rc = fn(ptr(scal), ptr(rows_i), ptr(rows_f), ptr(z), ptr(slot), ptr(lin),
            s_cap, chunk, TILE_H, TILE_W, n2, n3, hp, w, stream_ptr(dev))
    lib.check(rc, "kernel B1 (rq_queue_raster)")
    raster_attrs_queue_cuda.launches += 1
    return z, slot, lin


raster_attrs_queue_cuda.launches = 0


def raster_attrs_queue(queue: Queue, setup, extra_f, n2: int, n3: int,
                       h: int, w: int):
    """Rasterize + interpolate attribute planes through the flat queue.

    rustexp_tpu/ops/raster_queue.py:952 with tie=True. ``setup`` is a
    TriSetupP, ``extra_f`` 3*(n2+n3) planar [T] attribute channels.
    Returns (z, mask, lins tuple, stale); z and lins are meaningful only
    under mask. CUDA tensors launch kernel B1, CPU tensors take the plain
    version; ``stale`` is True when the cached queue no longer covers
    this frame (rebuild and re-render).
    """
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by {TILE_H}x{TILE_W}")
    if len(extra_f) != 3 * (n2 + n3):
        raise ValueError(f"{len(extra_f)} attribute channels for "
                         f"n2={n2}, n3={n3}")
    rows_i, rows_f = gather_rows(queue, _channel_table(setup, extra_f))
    dev = rows_f.device
    if dev.type == "cuda":
        z, slot, lin = raster_attrs_queue_cuda(
            queue.scal, rows_i, rows_f, n2, n3, h, w)
    elif dev.type == "cpu":
        z, slot, lin = raster_attrs_queue_plain(
            queue.scal, rows_i, rows_f, n2, n3, h, w)
    else:
        raise ValueError(f"no raster path for device {dev}")
    stale = ~check_queue_valid(queue, setup)
    return z[:h], slot[:h] >= 0, tuple(lin[:, :h]), stale


@functools.cache
def _b7_kernel():
    """The built kernel library and kernel B7's C entry, typed once."""
    lib = load_kernel_lib("raster_queue")
    fn = lib.lib.rq_queue_zslot
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return lib, fn


def raster_zslot_queue_cuda(scal, rows_i, rows_f, h: int, w: int):
    """Launch kernel B7 (csrc/raster_queue.cu, B1's kernel with no planes)
    -> (z, slot) over h + TILE_H rows, every word written by the one grid:
    where no pair won, z 1.0 and slot -1, as the plain version gives. The
    kernel finds a tile's chunks by a search, so scal must hold them in
    tile order (ty * ntx + tx ascending), as build_queue lays them out.
    Only rows_f's channels 0-6 are read.

    ``raster_zslot_queue_cuda.launches`` counts the grid launches.
    """
    dev = rows_f.device
    s_cap, n_ich, chunk = rows_i.shape
    for name, t, dt in (("scal", scal, torch.int32),
                        ("rows_i", rows_i, torch.int32),
                        ("rows_f", rows_f, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"kernel B7 runs on CUDA tensors, got {dev}")
    if (scal.shape != (s_cap, 5) or n_ich != _I_CH or rows_f.dim() != 3
            or rows_f.shape[0] != s_cap or rows_f.shape[1] < _F_CH
            or rows_f.shape[2] != chunk):
        raise ValueError(f"bad queue shapes: scal {tuple(scal.shape)}, "
                         f"rows_i {tuple(rows_i.shape)}, "
                         f"rows_f {tuple(rows_f.shape)}")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by {TILE_H}x{TILE_W}")
    lib, fn = _b7_kernel()
    hp = h + TILE_H
    z = torch.empty((hp, w), dtype=torch.float32, device=dev)
    slot = torch.empty((hp, w), dtype=torch.int32, device=dev)
    rc = fn(ptr(scal), ptr(rows_i), ptr(rows_f), ptr(z), ptr(slot), s_cap,
            chunk, TILE_H, TILE_W, rows_f.shape[1], hp, w, stream_ptr(dev))
    lib.check(rc, "kernel B7 (rq_queue_zslot)")
    raster_zslot_queue_cuda.launches += 1
    return z, slot


raster_zslot_queue_cuda.launches = 0


def raster_zslot_queue(queue: Queue, setup, extra_f, h: int, w: int):
    """Depth race only, through the flat queue
    (rustexp_tpu/ops/raster_queue.py:879, tie=True).

    Returns (z, slot, rows_flat, stale): `slot` is the winning queue slot
    per pixel (-1 = background), z the winner's depth (1.0 where none won),
    `rows_flat` [S*chunk + 1, CH] the slot-indexed channel table for the
    deferred shade to re-evaluate the winner's planes (gather_rows), and
    `stale` as raster_attrs_queue's. CUDA tensors launch kernel B7, CPU
    tensors take the plain version.
    """
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by {TILE_H}x{TILE_W}")
    rows_i, rows_f, rows_flat = gather_rows(
        queue, _channel_table(setup, list(extra_f)), return_flat=True)
    dev = rows_f.device
    if dev.type == "cuda":
        z, slot = raster_zslot_queue_cuda(queue.scal, rows_i, rows_f, h, w)
    elif dev.type == "cpu":
        z, slot = raster_zslot_queue_plain(queue.scal, rows_i, rows_f, h, w)
    else:
        raise ValueError(f"no raster path for device {dev}")
    stale = ~check_queue_valid(queue, setup)
    return z[:h], slot[:h], rows_flat, stale


# ---------------------------------------------------------------------------
# Kernel T: a frame's transform, triangle setup and channel table
# ---------------------------------------------------------------------------

_SETUP_PLANES = 20  # TriSetupP's int32/f32 fields before valid
_SETUP_N3 = (0, 3, 6)


class _SetupArgs(ctypes.Structure):
    """csrc/raster_queue.cu's SetupArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "cp3", "cn3", "cc3", "colors", "tris", "ndim", "it33", "table",
        "planes")]
        + [(name, ctypes.c_int) for name in ("n_tris", "w", "h", "y_shift")]
        + [("m", ctypes.c_float * 16)])


@functools.cache
def _t_kernel():
    """The built kernel library and kernel T's C entry, typed once."""
    lib = load_kernel_lib("raster_queue")
    fn = lib.lib.rq_queue_setup
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_SetupArgs), ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def queue_setup_cuda(cp3, cn3, cc3, ndim, it33, m, w: int, h: int,
                     y_shift: int = 0, *, n3: int | None = None,
                     colors=None, tris=None) -> TriSetupP:
    """Launch kernel T (csrc/raster_queue.cu) -> the TriSetupP of one
    frame, its planes views of one buffer; with `n3`, also its channel
    table (``table``), whose attribute columns are queue_attr_channels'
    ``extra``. Bit for bit the plain chain: raster/pipeline.py's
    transform_corners_planar and setup_triangles_planar (an h-row frame,
    rows shifted by y_shift after the snap), and with n3 its channels and
    pack_table.

    The scene's corner planes cp3 f32 [3, 4, T], cn3 and cc3 f32 [3, 3, T],
    ndim f32 [4, 4] and it33 f32 [3, 3] lie on the card; `m`, the host's
    world-to-viewport matrix (16 values), goes by value. n3 None: the
    setup alone; 0: the V modes' channels, from the per-vertex `colors`
    f32 [V, 3] through `tris` i32 [T, 3]; 3 or 6: per pixel, the baked
    colours cc3 and the normals (3), or world positions and normals (6).

    ``queue_setup_cuda.launches`` counts the grid launches.
    """
    dev = cp3.device
    T = cp3.shape[-1] if cp3.dim() == 3 else -1
    want = [("cp3", cp3, torch.float32, (3, 4, T)),
            ("cn3", cn3, torch.float32, (3, 3, T)),
            ("cc3", cc3, torch.float32, (3, 3, T)),
            ("ndim", ndim, torch.float32, (4, 4)),
            ("it33", it33, torch.float32, (3, 3))]
    if n3 == 0:
        if colors is None or tris is None:
            raise ValueError("n3=0 (per-vertex colours) needs colors and "
                             "tris")
        want += [("colors", colors, torch.float32, (colors.shape[0], 3)),
                 ("tris", tris, torch.int32, (T, 3))]
    elif n3 is not None and n3 not in _SETUP_N3:
        raise ValueError(f"kernel T takes n3 in {_SETUP_N3} or None, got "
                         f"{n3}")
    elif colors is not None:
        raise ValueError("colors are read only with n3=0")
    for name, t, dt, shp in want:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shp
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shp} tensor "
                             f"on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    m = torch.as_tensor(m)
    if m.device.type != "cpu" or m.numel() != 16:
        raise ValueError(f"m: need 16 host values, got {m.numel()} on "
                         f"{m.device}")
    if w <= 0 or h <= 0:
        raise ValueError(f"frame {h}x{w}")
    if dev.type != "cuda":
        raise ValueError(f"kernel T runs on CUDA tensors, got {dev}")
    lib, fn = _t_kernel()
    nw = _SETUP_PLANES * T
    buf = torch.empty(4 * nw + T, dtype=torch.uint8, device=dev)
    words = buf[:4 * nw].view(torch.int32).view(_SETUP_PLANES, T)
    table = None if n3 is None else torch.empty(
        (T + 1, _I_CH + _F_CH + 3 * (4 + n3)), dtype=torch.float32,
        device=dev)

    def addr(t):
        return None if t is None else t.data_ptr()

    args = _SetupArgs(
        cp3=cp3.data_ptr(), cn3=cn3.data_ptr(), cc3=cc3.data_ptr(),
        colors=addr(colors if n3 == 0 else None),
        tris=addr(tris if n3 == 0 else None), ndim=ndim.data_ptr(),
        it33=it33.data_ptr(), table=addr(table), planes=buf.data_ptr(),
        n_tris=T, w=w, h=h, y_shift=y_shift,
        m=(ctypes.c_float * 16)(*m.to(torch.float32).reshape(-1).tolist()))
    rc = fn(ctypes.byref(args), -1 if n3 is None else n3, stream_ptr(dev))
    lib.check(rc, "kernel T (rq_queue_setup)")
    queue_setup_cuda.launches += 1
    i = words.unbind(0)
    f = [i[k].view(torch.float32) for k in range(9, 16)]
    return TriSetupP(
        A0=i[0], A1=i[1], B0=i[2], B1=i[3], C0=i[4], C1=i[5], C2=i[6],
        A2=i[7], B2=i[8], bias0=f[0], bias1=f[1], bias2=f[2], inv_a2=f[3],
        z0=f[4], z10=f[5], z20=f[6], min_x=i[16], min_y=i[17],
        max_x=i[18], max_y=i[19], valid=buf[4 * nw:].view(torch.bool),
        table=table)


queue_setup_cuda.launches = 0


def suggest_queue_config(setup_stats, margin: float = 1.3,
                         tile_margin: float = 1.15):
    """Static (s_cap, m_y, m_x, t_cap) from queue_stats, quantized so nearby
    viewpoints give the same caps (rustexp_tpu/ops/raster_queue.py:1033)."""
    total_chunks, sy, sx, occ_rows = setup_stats[:4]
    s_cap = max(16, -(-int(int(total_chunks) * margin + 4) // 16) * 16)
    t_cap = max(64, -(-int(int(occ_rows) * tile_margin + 8) // 64) * 64)
    return s_cap, int(sy) + 1, int(sx) + 1, t_cap


def queue_stats(setup, h: int, w: int, row_stride: int = 1,
                row_offset: int = 0):
    """(CHUNK count, max span_y, max span_x, occupied SHADE_W blocks,
    occupied TILE_W blocks) as 0-d tensors
    (rustexp_tpu/ops/raster_queue.py:1059). `row_stride`/`row_offset`
    count only one band of the cyclic interleave (build_queue's); the
    span maxima stay global, as build_queue enumerates global spans."""
    dev = setup.valid.device
    i32 = dict(dtype=torch.int32, device=dev)
    ntx = w // TILE_W
    nty = h // TILE_H // row_stride
    ty0, ty1, tx0, tx1 = tile_ranges(setup)
    span_y = torch.where(setup.valid, ty1 - ty0 + 1, 1)
    span_x = torch.where(setup.valid, tx1 - tx0 + 1, 1)

    ty = torch.arange(nty, **i32) * row_stride + row_offset   # global rows
    tx = torch.arange(ntx, **i32)
    cov_y = (ty[None, :] >= ty0[:, None]) & (ty[None, :] <= ty1[:, None])
    cov_x = (tx[None, :] >= tx0[:, None]) & (tx[None, :] <= tx1[:, None])
    covf = (cov_y[:, :, None] & cov_x[:, None, :]
            & setup.valid[:, None, None]).reshape(-1, nty * ntx)
    counts = covf.sum(dim=0, dtype=torch.int32)
    total_chunks = _fdiv(counts + (CHUNK - 1), CHUNK).sum(dtype=torch.int32)
    ymin_t = torch.where(covf, (setup.min_y - ROW_MARGIN).clamp(min=0)[:, None],
                         h).amin(dim=0)
    ymax_t = torch.where(covf, (setup.max_y + ROW_MARGIN).clamp(max=h)[:, None],
                         0).amax(dim=0)
    xmin_t = torch.where(covf, (setup.min_x - ROW_MARGIN).clamp(min=0)[:, None],
                         w).amin(dim=0)
    xmax_t = torch.where(covf, (setup.max_x + ROW_MARGIN).clamp(max=w)[:, None],
                         0).amax(dim=0)
    tiles = torch.arange(nty * ntx, **i32)
    t_lo = (_fdiv(tiles, ntx) * row_stride + row_offset) * TILE_H  # global
    rows_per_tile = (torch.minimum(ymax_t, t_lo + TILE_H)
                     - torch.maximum(ymin_t, t_lo)).clamp(0, TILE_H)
    spt = TILE_W // SHADE_W
    tb_lo = (tiles % ntx) * spt
    blk_lo = torch.maximum(_fdiv(xmin_t, SHADE_W), tb_lo)
    blk_hi = torch.minimum(_fdiv(xmax_t.clamp(min=1) - 1, SHADE_W),
                           tb_lo + spt - 1)
    blocks_per_row = (blk_hi - blk_lo + 1).clamp(0, spt)
    occ_fine = (rows_per_tile * blocks_per_row).sum(dtype=torch.int32)
    occ_tile = rows_per_tile.sum(dtype=torch.int32)
    return (total_chunks, span_y.max(), span_x.max(), occ_fine, occ_tile)


def read_queue_stats(setup, h: int, w: int, row_stride: int = 1,
                     row_offset: int = 0) -> tuple:
    """queue_stats as five Python ints, read back from the device at once
    (the span sync.read.queue_stats)."""
    stats = torch.stack(queue_stats(setup, h, w, row_stride, row_offset))
    with trace.span("sync.read.queue_stats"):
        return tuple(stats.tolist())

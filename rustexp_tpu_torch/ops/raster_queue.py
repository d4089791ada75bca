"""Flat-queue tile rasterizer: queue build, row gather and kernel B1.

Port of rustexp_tpu/ops/raster_queue.py. The screen is tiled 16x128;
each tile owns a contiguous, chunk-aligned segment of a flat queue of
(tile, triangle) pairs, and per-chunk scalars (ty, tx, first, count,
global ty) tell the raster kernel which tile a chunk of 128 pairs
belongs to. The queue STRUCTURE depends only on AABB/tile geometry, so
callers cache it across frames and re-gather the per-frame rows;
``check_queue_valid`` says when the camera moved too far.

Ported here: the ``order="tri"`` build (ascending triangle id within
each tile, from one pair-key sort) with ``row_stride=1``; ``"auto"``
resolves to ``"tri"``. The kernel always races on (z, triangle id), so
its frames equal what the JAX package renders with any order.
``"plane"``/``"direct"`` and the band interleave are ROADMAP A6/A16.

Kernel B1 (``csrc/raster_queue.cu``, replacing ``_queue_kernel``) runs
for CUDA tensors; ``raster_attrs_queue_plain`` is its plain PyTorch
version and serves CPU tensors. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..runtime import load_kernel_lib, ptr, stream_ptr
from .ieee import lerp_2mad, lerp_3w

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
_B1_PLANES = ((4, 0), (4, 3))  # (n2, n3) the kernel is instantiated for: V, P


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


def tile_ranges(setup):
    """Inclusive tile index ranges covered by each clipped pixel AABB."""
    ty0 = _fdiv(setup.min_y, TILE_H)
    ty1 = _fdiv(setup.max_y - 1, TILE_H)
    tx0 = _fdiv(setup.min_x, TILE_W)
    tx1 = _fdiv(setup.max_x - 1, TILE_W)
    return ty0, ty1, tx0, tx1


def build_queue(setup, h: int, w: int, *, s_cap: int, m_y: int, m_x: int,
                t_cap: int | None = None, order: str = "auto",
                shade_w: int = SHADE_W) -> Queue:
    """Construct the flat queue from a frame's setup, ``order="tri"``.

    rustexp_tpu/ops/raster_queue.py:223 (the pair-key sort :415-450, slot
    gather :522-528, chunk layout :452-483 and shade-block rows list
    :535-604), with the whole frame as one band.
    """
    if order not in ("auto", "tri"):
        raise NotImplementedError(
            f"build_queue order={order!r} is not ported yet (ROADMAP A6)")
    dev = setup.valid.device
    i32 = dict(dtype=torch.int32, device=dev)
    nty, ntx = h // TILE_H, w // TILE_W
    n_tiles = nty * ntx
    T = setup.valid.shape[0]
    valid = setup.valid

    ty0, ty1, tx0, tx1 = tile_ranges(setup)
    span_y = ty1 - ty0 + 1
    span_x = tx1 - tx0 + 1

    ty_ar = torch.arange(nty, **i32)
    tx_ar = torch.arange(ntx, **i32)
    cov_y = (ty_ar[None, :] >= ty0[:, None]) & (ty_ar[None, :] <= ty1[:, None])
    cov_x = (tx_ar[None, :] >= tx0[:, None]) & (tx_ar[None, :] <= tx1[:, None])
    cov = (cov_y[:, :, None] & cov_x[:, None, :]
           & valid[:, None, None]).reshape(T, n_tiles)

    # Pair enumeration per (triangle, dy, dx); tiles beyond the m_y/m_x
    # spans are not enumerated (overflow flag below). Keys sort by
    # (tile, tri): ascending triangle id within a tile.
    dy = torch.arange(m_y, **i32)
    dx = torch.arange(m_x, **i32)
    t_ty = ty0[:, None, None] + dy[None, :, None]
    t_tx = tx0[:, None, None] + dx[None, None, :]
    ok = (valid[:, None, None]
          & (dy[None, :, None] < span_y[:, None, None])
          & (dx[None, None, :] < span_x[:, None, None]))
    tile_id = t_ty * ntx + t_tx
    tri_id = torch.arange(T, **i32)[:, None, None].expand_as(tile_id)
    big = n_tiles * T
    skey = torch.sort(torch.where(ok, tile_id * T + tri_id, big)
                      .reshape(-1)).values
    bounds = torch.searchsorted(
        skey, torch.arange(n_tiles + 1, **i32) * T, out_int32=True)
    counts = bounds[1:] - bounds[:-1]

    # Chunk-aligned segment layout; pad chunks go to the extra tile row
    # ty = nty, which the raster wrappers slice off.
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
    scal = torch.stack([ty, tx, first.to(torch.int32), cnt, ty], dim=1)

    slot_ok = torch.arange(CHUNK, **i32)[None, :] < cnt[:, None]
    pos = ((bounds[tile_of] + k_of * CHUNK)[:, None]
           + torch.arange(CHUNK, **i32)[None, :])
    src = skey[pos.clamp(0, skey.shape[0] - 1).reshape(-1)]
    ids = torch.where(slot_ok, src.reshape(s_cap, CHUNK) % T, -1)

    overflow = ((total_chunks > s_cap)
                | (valid & ((span_y > m_y) | (span_x > m_x))).any())

    # Occupied shade-block list: a block (one shade_w-wide span of one
    # row) can hold coverage only inside the ROW_MARGIN-expanded extents
    # of the pair AABBs landing in its tile.
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
    rb_y = _fdiv(rbid, nsx)
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
                 shade_w=int(shade_w))


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


def gather_rows(queue: Queue, tabT: torch.Tensor):
    """One row gather per queue slot -> (rows_i i32 [S, 12, chunk],
    rows_f f32 [S, F, chunk]), channel-major per chunk
    (rustexp_tpu/ops/raster_queue.py:659)."""
    s_cap, chunk = queue.ids.shape
    sentinel = tabT.shape[0] - 1
    flat = torch.where(queue.ids < 0, sentinel, queue.ids).reshape(-1)
    rows = tabT[flat].reshape(s_cap, chunk, -1).permute(0, 2, 1)
    rows_i = rows[:, :_I_CH].contiguous().view(torch.int32)
    rows_f = rows[:, _I_CH:].contiguous()
    return rows_i, rows_f


# ---------------------------------------------------------------------------
# Kernel B1 and its plain version
# ---------------------------------------------------------------------------


def _eval_pairs(ci, cf, xs, ys, n2: int, n3: int, planes: bool):
    """Depth (and attribute planes) of pairs at pixels — _queue_kernel's
    per-pair math (rustexp_tpu/ops/raster_queue.py:726-775).

    ``ci``/``cf`` index the int/float channels on dim 0; the rest of their
    shape broadcasts against the int32 pixel coordinates ``xs``/``ys``.
    Returns (zm, lins): zm is +inf outside the triangle or its AABB.
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
    zi = lerp_2mad(cf[3], cf[4], cf[5], b2, b0)
    zm = torch.where(inside & in_box, zi, torch.inf)
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


def raster_attrs_queue_plain(scal, rows_i, rows_f, n2: int, n3: int,
                             h: int, w: int):
    """Plain PyTorch version of kernel B1 -> (z, slot, lin) over h + TILE_H rows.

    The kernel walks each tile's pairs in queue order and keeps a pixel's
    fragment when (z, tri) < (z_cur, tri_cur), starting from the clear
    (1.0, INT32_MAX). That is the lexicographic minimum over the tile's
    pairs and the clear, so this version evaluates batches of pairs as
    one tensor, takes the minimum with a scatter, finds the winning pair
    in a second pass, and re-evaluates only the winner's planes (same
    formula, same bits). Pixels nobody wins keep the clear: z 1.0, slot
    -1, planes 0.
    """
    dev = rows_f.device
    s_cap, _, chunk = rows_i.shape
    hp = h + TILE_H
    npl = n2 + n3
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
                            n2, n3, planes=False)
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
    winner = torch.full((hp * w,), -1, dtype=torch.int64, device=dev)
    for lo in range(0, n_pairs, step):
        key, idx = batch(lo, lo + step)
        pair = torch.arange(lo, min(lo + step, n_pairs), device=dev)
        pair = pair[:, None].expand(-1, TILE_H * TILE_W).reshape(-1)
        # (z, tri) is unique within a tile, so one pair hits per pixel
        winner.scatter_reduce_(0, idx, torch.where(key == best[idx], pair, -1),
                               reduce="amax")

    pix = (winner >= 0).nonzero().squeeze(1)
    wp = winner[pix]
    xs = (pix % w).to(torch.int32)
    ys = gty[wp] * TILE_H + (_fdiv(pix, w) % TILE_H).to(torch.int32)
    zm, lins = _eval_pairs(pi[wp].T, pf[wp].T, xs, ys, n2, n3, planes=True)
    z = torch.ones(hp * w, dtype=torch.float32, device=dev)
    z[pix] = zm
    slot = torch.full((hp * w,), -1, dtype=torch.int32, device=dev)
    slot[pix] = (c_idx * chunk + p_idx)[wp].to(torch.int32)
    lin = torch.zeros((npl, hp * w), dtype=torch.float32, device=dev)
    lin[:, pix] = torch.stack(lins)
    return z.reshape(hp, w), slot.reshape(hp, w), lin.reshape(npl, hp, w)


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
    h + TILE_H rows. z and lin are unwritten (garbage) where slot < 0 in
    tiles no chunk visits; slot is prefilled with -1 there.

    ``raster_attrs_queue_cuda.launches`` counts the launches.
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
    slot = torch.full((hp, w), -1, dtype=torch.int32, device=dev)
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
    rows_i, rows_f = gather_rows(queue, pack_table(setup, extra_f))
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


def suggest_queue_config(setup_stats, margin: float = 1.3,
                         tile_margin: float = 1.15):
    """Static (s_cap, m_y, m_x, t_cap) from queue_stats, quantized so nearby
    viewpoints give the same caps (rustexp_tpu/ops/raster_queue.py:1033)."""
    total_chunks, sy, sx, occ_rows = setup_stats[:4]
    s_cap = max(16, -(-int(int(total_chunks) * margin + 4) // 16) * 16)
    t_cap = max(64, -(-int(int(occ_rows) * tile_margin + 8) // 64) * 64)
    return s_cap, int(sy) + 1, int(sx) + 1, t_cap


def queue_stats(setup, h: int, w: int):
    """(CHUNK count, max span_y, max span_x, occupied SHADE_W blocks,
    occupied TILE_W blocks) as 0-d tensors
    (rustexp_tpu/ops/raster_queue.py:1059, whole frame)."""
    dev = setup.valid.device
    i32 = dict(dtype=torch.int32, device=dev)
    nty, ntx = h // TILE_H, w // TILE_W
    ty0, ty1, tx0, tx1 = tile_ranges(setup)
    span_y = torch.where(setup.valid, ty1 - ty0 + 1, 1)
    span_x = torch.where(setup.valid, tx1 - tx0 + 1, 1)

    ty = torch.arange(nty, **i32)
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
    t_lo = _fdiv(tiles, ntx) * TILE_H
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

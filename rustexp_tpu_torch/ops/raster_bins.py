"""Binned tile rasterizer: the [nT, cap] bins and kernels B2 and B3.

Port of rustexp_tpu/ops/raster_pallas.py (BinnedTris, bin_triangles,
bin_pairs, max_bin_count, max_spans, attr_channels_2mad,
attr_channels_3w, raster_attrs_pallas and raster_gbuffer_pallas). The screen is cut into 32x128
tiles; every front-facing triangle is binned, in submission order, to the
tiles its pixel AABB overlaps, and the raster walks each tile's bin in
slot order with a strict z < depth race, so an earlier triangle keeps a
tie. This is the main path for meshes under 1,000 triangles and for
``render_frame`` without a structure (raster/structure.py).

Kernel B2 (``csrc/raster_bins.cu``, replacing ``_attr_tile_kernel``) runs
for CUDA tensors; ``raster_attrs_bins_plain`` is its plain PyTorch
version and serves CPU tensors. Kernel B3 (the same file, replacing
``_tile_kernel``) is B2's G-buffer form behind ``raster_gbuffer_pallas``,
the band renderer's raster: the winner's bin slot and barycentrics
instead of planes; ``raster_gbuffer_bins_plain`` is its plain version.
There is no fallback between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..runtime import load_kernel_lib, ptr, stream_ptr
from .raster_queue import _barycentrics, _eval_pairs, _fdiv
from .raster_xla import GBuffer

TILE_H = 32
TILE_W = 128
GROUP = 8  # the TPU kernel's triangles per step; the cap rounds to it

# int channels: A0 A1 B0 B1 C0 C1 S min_x min_y max_x max_y tri
_I_CH = 12
_F_CH = 7  # bias0 bias1 bias2 z0 z10 z20 inv_a2  (+ 3*(n2+n3) attr channels)
_PLAIN_SLOTS = 32  # bin slots the plain B2 evaluates per pass
_B2_PLANES = ((4, 0), (4, 6))  # (n2, n3) the kernel is instantiated for: V, P


class BinnedTris(NamedTuple):
    """Per-tile triangle bins (rustexp_tpu/ops/raster_pallas.py:56)."""

    setup_i: torch.Tensor   # i32 [nT, cap, 12] per-slot triangle data
    setup_f: torch.Tensor   # f32 [nT, cap, 7 + extra]
    ids: torch.Tensor       # i32 [nT, cap] triangle index per slot
    counts: torch.Tensor    # i32 [nT] triangles in each bin (clamped to cap)
    overflow: torch.Tensor  # bool [] a bin exceeded cap or a span its budget


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_ranges(setup, tile_h: int, tile_w: int):
    """Inclusive tile index ranges (ty0, ty1, tx0, tx1) of each clipped,
    half-open pixel AABB."""
    return (_fdiv(setup.min_y, tile_h), _fdiv(setup.max_y - 1, tile_h),
            _fdiv(setup.min_x, tile_w), _fdiv(setup.max_x - 1, tile_w))


def _coverage(setup, h: int, w: int, tile_h: int, tile_w: int):
    """bool [T, nT]: which tiles each valid triangle's AABB overlaps."""
    nty, ntx = _cdiv(h, tile_h), _cdiv(w, tile_w)
    ty0, ty1, tx0, tx1 = _tile_ranges(setup, tile_h, tile_w)
    i32 = dict(dtype=torch.int32, device=setup.valid.device)
    tx = torch.arange(ntx, **i32)
    ty = torch.arange(nty, **i32)
    cov_x = (tx[None, :] >= tx0[:, None]) & (tx[None, :] <= tx1[:, None])
    cov_y = (ty[None, :] >= ty0[:, None]) & (ty[None, :] <= ty1[:, None])
    cov = cov_y[:, :, None] & cov_x[:, None, :] & setup.valid[:, None, None]
    return cov.reshape(-1, nty * ntx)


def _gather_slots(setup, extra_f, ids, slot_ok):
    """Pack the per-triangle channels, then gather one row per bin slot.
    Empty slots get max_x = max_y = 0: their AABB admits no pixel."""
    T = setup.A.shape[0]
    i32 = dict(dtype=torch.int32, device=setup.A.device)
    packed_i = torch.cat(
        [setup.A[:, :2], setup.B[:, :2], setup.C[:, :2],
         (setup.C[:, 0] + setup.C[:, 1] + setup.C[:, 2])[:, None],
         setup.min_x[:, None], setup.min_y[:, None],
         setup.max_x[:, None], setup.max_y[:, None],
         torch.arange(T, **i32)[:, None]], dim=1)             # [T, 12]
    f_parts = [setup.bias, setup.z0[:, None], setup.z10[:, None],
               setup.z20[:, None], setup.inv_a2[:, None]]
    if extra_f is not None:
        f_parts.append(extra_f)
    packed_f = torch.cat(f_parts, dim=1)                      # [T, 7 + extra]
    flat = ids.reshape(-1).long()
    n_tiles, k = ids.shape
    setup_i = packed_i[flat].reshape(n_tiles, k, _I_CH)
    setup_f = packed_f[flat].reshape(n_tiles, k, -1)
    box_max = torch.zeros(_I_CH, dtype=torch.bool, device=ids.device)
    box_max[9:11] = True
    setup_i = torch.where(~slot_ok[..., None] & box_max, 0, setup_i)
    return setup_i, setup_f


def bin_triangles(setup, h: int, w: int, cap: int, tile_h: int = TILE_H,
                  tile_w: int = TILE_W, extra_f=None) -> BinnedTris:
    """Coverage-matrix binning with stable compaction
    (rustexp_tpu/ops/raster_pallas.py:64).

    A stable argsort of the inverted [T, nT] coverage puts each tile's
    covered triangle ids first, in submission order; the depth race's
    tie rule depends on that order. Empty slots keep the argsort's ids;
    when T < cap the bins are zero-padded to cap slots.
    """
    cov = _coverage(setup, h, w, tile_h, tile_w)
    full_counts = cov.sum(dim=0, dtype=torch.int32)
    counts = full_counts.clamp(max=cap)
    overflow = (full_counts > cap).any()
    order = torch.argsort((~cov).to(torch.uint8), dim=0, stable=True)[:cap]
    ids = order.T.to(torch.int32).contiguous()                # [nT, k<=cap]
    k = ids.shape[1]
    slot_ok = torch.arange(k, dtype=torch.int32,
                           device=ids.device)[None, :] < counts[:, None]
    setup_i, setup_f = _gather_slots(setup, extra_f, ids, slot_ok)
    if k < cap:  # argsort returned fewer rows than capacity (T < cap)
        pad = cap - k
        setup_i = F.pad(setup_i, (0, 0, 0, pad))
        setup_f = F.pad(setup_f, (0, 0, 0, pad))
        ids = F.pad(ids, (0, pad))
    return BinnedTris(setup_i, setup_f, ids, counts, overflow)


def bin_pairs(setup, h: int, w: int, cap: int, m_x: int, m_y: int,
              tile_h: int = TILE_H, tile_w: int = TILE_W,
              extra_f=None) -> BinnedTris:
    """Pairs-sort binning (rustexp_tpu/ops/raster_pallas.py:531).

    Up to m_x*m_y (tile, triangle) pairs per triangle, one flat sort of
    the keys tile*T + tri (ascending triangle id within a tile), and each
    tile's segment found by searchsorted. Empty slots get id 0.
    ``overflow`` fires when a bin exceeds cap or a triangle spans more
    tiles than (m_x, m_y).
    """
    nty, ntx = _cdiv(h, tile_h), _cdiv(w, tile_w)
    n_tiles = nty * ntx
    T = setup.A.shape[0]
    i32 = dict(dtype=torch.int32, device=setup.A.device)
    ty0, ty1, tx0, tx1 = _tile_ranges(setup, tile_h, tile_w)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1

    dx = torch.arange(m_x, **i32)
    dy = torch.arange(m_y, **i32)
    t_ty = ty0[:, None, None] + dy[None, :, None]              # [T, m_y, m_x]
    t_tx = tx0[:, None, None] + dx[None, None, :]
    ok = (setup.valid[:, None, None]
          & (dy[None, :, None] < span_y[:, None, None])
          & (dx[None, None, :] < span_x[:, None, None]))
    tile_id = t_ty * ntx + t_tx
    tri_id = torch.arange(T, **i32)[:, None, None].expand_as(tile_id)
    key = torch.where(ok, tile_id * T + tri_id, n_tiles * T).reshape(-1)
    skey = torch.sort(key).values

    bounds = torch.searchsorted(skey, torch.arange(n_tiles + 1, **i32) * T,
                                out_int32=True)
    full_counts = bounds[1:] - bounds[:-1]
    counts = full_counts.clamp(max=cap)
    overflow = ((full_counts > cap).any()
                | (setup.valid & ((span_x > m_x) | (span_y > m_y))).any())

    slots = torch.arange(cap, **i32)
    pos = (bounds[:-1, None] + slots[None, :]).clamp(max=skey.shape[0] - 1)
    slot_ok = slots[None, :] < counts[:, None]
    ids = torch.where(slot_ok, skey[pos.reshape(-1).long()]
                      .reshape(n_tiles, cap) % T, 0)
    setup_i, setup_f = _gather_slots(setup, extra_f, ids, slot_ok)
    return BinnedTris(setup_i, setup_f, ids, counts, overflow)


def max_bin_count(setup, h: int, w: int, tile_h: int = TILE_H,
                  tile_w: int = TILE_W) -> torch.Tensor:
    """Largest bin's triangle count, 0-d (raster_pallas.py:498)."""
    return _coverage(setup, h, w, tile_h, tile_w).sum(
        dim=0, dtype=torch.int32).max()


def max_spans(setup, h: int, w: int, tile_h: int = TILE_H,
              tile_w: int = TILE_W):
    """(max span_x, max span_y) in tiles over valid triangles, 0-d each
    (raster_pallas.py:609)."""
    ty0, ty1, tx0, tx1 = _tile_ranges(setup, tile_h, tile_w)
    return (torch.where(setup.valid, tx1 - tx0 + 1, 1).max(),
            torch.where(setup.valid, ty1 - ty0 + 1, 1).max())


def attr_channels_2mad(iw0, iw1, iw2, a0, a1, a2):
    """Per-triangle (q0, q10, q20) channels of the 2-MAD form, a/w
    (raster_pallas.py:318). Each product rounds before the subtraction,
    like the reference's per-triangle c10/c20 (oracle.cpp:1242-1243)."""
    q0 = a0 * iw0[:, None]
    return torch.cat([q0, a1 * iw1[:, None] - q0, a2 * iw2[:, None] - q0],
                     dim=1)


def attr_channels_3w(iw0, iw1, iw2, a0, a1, a2):
    """Per-triangle (qb1, qb2, qb0) channels of the three-weight form
    (raster_pallas.py:331)."""
    return torch.cat([a0 * iw0[:, None], a1 * iw1[:, None],
                      a2 * iw2[:, None]], dim=1)


# ---------------------------------------------------------------------------
# Kernel B2 and its plain version
# ---------------------------------------------------------------------------


def _tiles_to_frame(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., nT, TILE_H, TILE_W] tile-major -> [..., h, w]."""
    lead = t.shape[:-3]
    nty, ntx = h // TILE_H, w // TILE_W
    t = t.reshape(*lead, nty, ntx, TILE_H, TILE_W)
    return t.transpose(-3, -2).reshape(*lead, h, w)


def _bins_race(counts, setup_i, setup_f, h: int, w: int):
    """The depth race of kernels B2 and B3, plain: (z, slot) tile-major
    [nT, TILE_H, TILE_W].

    Per pixel, the kernels walk its tile's slots s < counts[tile] in order
    and keep a fragment when z < z_cur (strict), starting from the clear
    z = 1.0, slot = -1. Here each pass evaluates _PLAIN_SLOTS slots of
    every tile at once, takes the first minimum of the pass (the earliest
    slot among equal z) and merges it into the running state with the
    same strict <.
    """
    dev = setup_f.device
    n_tiles, cap, _ = setup_i.shape
    ntx = w // TILE_W
    i32 = dict(dtype=torch.int32, device=dev)
    tiles = torch.arange(n_tiles, **i32)
    xs = ((tiles % ntx) * TILE_W)[:, None, None, None] \
        + torch.arange(TILE_W, **i32)[None, None, None, :]  # [nT, 1, 1, TW]
    ys = (_fdiv(tiles, ntx) * TILE_H)[:, None, None, None] \
        + torch.arange(TILE_H, **i32)[None, None, :, None]  # [nT, 1, TH, 1]
    z = torch.ones((n_tiles, TILE_H, TILE_W), dtype=torch.float32, device=dev)
    slot = torch.full((n_tiles, TILE_H, TILE_W), -1, **i32)
    n_max = int(counts.max()) if n_tiles else 0
    for lo in range(0, min(n_max, cap), _PLAIN_SLOTS):
        hi = min(lo + _PLAIN_SLOTS, cap)
        ci = setup_i[:, lo:hi].permute(2, 0, 1)[..., None, None]
        cf = setup_f[:, lo:hi, :_F_CH].permute(2, 0, 1)[..., None, None]
        zm, _ = _eval_pairs(ci, cf, xs, ys, 0, 0, planes=False)
        live = torch.arange(lo, hi, **i32)[None, :] < counts[:, None]
        zm = torch.where(live[..., None, None] & ~torch.isnan(zm), zm,
                         torch.inf)                       # [nT, c, TH, TW]
        first = (zm == zm.amin(dim=1, keepdim=True)).to(torch.uint8) \
            .argmax(dim=1, keepdim=True)
        zsel = zm.gather(1, first).squeeze(1)
        upd = zsel < z
        z = torch.where(upd, zsel, z)
        slot = torch.where(upd, first.squeeze(1).to(torch.int32) + lo, slot)
    return z, slot


def _winners(setup_i, setup_f, slot, w: int):
    """The won pixels of a tile-major slot plane: (tile, row, col) indices,
    the winners' int and float channels ([12, n], [F, n]) and their int32
    frame coordinates."""
    ntx = w // TILE_W
    t_i, y_i, x_i = (slot >= 0).nonzero(as_tuple=True)
    won = slot[t_i, y_i, x_i].long()
    xs = ((t_i % ntx) * TILE_W + x_i).to(torch.int32)
    ys = (_fdiv(t_i, ntx) * TILE_H + y_i).to(torch.int32)
    return (t_i, y_i, x_i), setup_i[t_i, won].T, setup_f[t_i, won].T, xs, ys


def raster_attrs_bins_plain(counts, setup_i, setup_f, n2: int, n3: int,
                            h: int, w: int):
    """Plain PyTorch version of kernel B2 -> (z, slot, lin) over [h, w].

    _bins_race finds each pixel's winning slot; then only the winners'
    planes are evaluated, with the kernel's formula on the winner's
    record, so they carry the same bits. Pixels nobody wins keep z 1.0,
    slot -1, planes 0.
    """
    z, slot = _bins_race(counts, setup_i, setup_f, h, w)
    idx, ci, cf, xs, ys = _winners(setup_i, setup_f, slot, w)
    _, lins = _eval_pairs(ci, cf, xs, ys, n2, n3, planes=True)
    lin = torch.zeros((n2 + n3,) + tuple(slot.shape), dtype=torch.float32,
                      device=setup_f.device)
    if lins:
        lin[(slice(None),) + idx] = torch.stack(lins)
    return (_tiles_to_frame(z, h, w), _tiles_to_frame(slot, h, w),
            _tiles_to_frame(lin, h, w))


def raster_gbuffer_bins_plain(counts, setup_i, setup_f, h: int, w: int):
    """Plain PyTorch version of kernel B3 -> (z, slot, b) with z and slot
    [h, w] and b [3, h, w]: B2's race, then the winner's barycentrics
    (b0, b1, b2) from its record. Pixels nobody wins: z 1.0, slot -1, b 0.
    """
    z, slot = _bins_race(counts, setup_i, setup_f, h, w)
    idx, ci, cf, xs, ys = _winners(setup_i, setup_f, slot, w)
    b = torch.zeros((3,) + tuple(slot.shape), dtype=torch.float32,
                    device=setup_f.device)
    b[(slice(None),) + idx] = torch.stack(_barycentrics(ci, cf, xs, ys)[1:])
    return (_tiles_to_frame(z, h, w), _tiles_to_frame(slot, h, w),
            _tiles_to_frame(b, h, w))


@functools.cache
def _b2_kernel():
    """The built kernel library and its C entry, typed once."""
    lib = load_kernel_lib("raster_bins")
    fn = lib.lib.rb_bins_raster
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return lib, fn


def raster_attrs_bins_cuda(counts, setup_i, setup_f, n2: int, n3: int,
                           h: int, w: int):
    """Launch kernel B2 (csrc/raster_bins.cu) -> (z, slot, lin) over
    [h, w]; every pixel is written, the clear where no slot wins.

    ``raster_attrs_bins_cuda.launches`` counts the launches.
    """
    dev = setup_f.device
    n_tiles, cap, n_ich = setup_i.shape
    npl = n2 + n3
    for name, t, dt in (("counts", counts, torch.int32),
                        ("setup_i", setup_i, torch.int32),
                        ("setup_f", setup_f, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"kernel B2 runs on CUDA tensors, got {dev}")
    if (n2, n3) not in _B2_PLANES:
        raise ValueError(f"kernel B2 is built for (n2, n3) in {_B2_PLANES}, "
                         f"got {(n2, n3)}")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by {TILE_H}x{TILE_W}")
    if (counts.shape != (n_tiles,) or n_ich != _I_CH
            or n_tiles != (h // TILE_H) * (w // TILE_W)
            or setup_f.shape != (n_tiles, cap, _F_CH + 3 * npl)):
        raise ValueError(f"bad bins shapes: counts {tuple(counts.shape)}, "
                         f"setup_i {tuple(setup_i.shape)}, setup_f "
                         f"{tuple(setup_f.shape)} for a {h}x{w} frame, "
                         f"n2={n2}, n3={n3}")
    lib, fn = _b2_kernel()
    z = torch.empty((h, w), dtype=torch.float32, device=dev)
    slot = torch.empty((h, w), dtype=torch.int32, device=dev)
    lin = torch.empty((npl, h, w), dtype=torch.float32, device=dev)
    rc = fn(ptr(counts), ptr(setup_i), ptr(setup_f), ptr(z), ptr(slot),
            ptr(lin), n_tiles, cap, TILE_H, TILE_W, n2, n3, h, w,
            stream_ptr(dev))
    lib.check(rc, "kernel B2 (rb_bins_raster)")
    raster_attrs_bins_cuda.launches += 1
    return z, slot, lin


raster_attrs_bins_cuda.launches = 0


def _bins_cap(T: int, cap: int | None, chunk: int = 512) -> int:
    """The static bin capacity of the Pallas wrappers for T triangles
    (rustexp_tpu/ops/raster_pallas.py:243-247 and :446-453): at most T
    rounded up to GROUP, rounded up to a whole number of chunks."""
    if cap is None:
        cap = min(_round_up(T, 512), 32768)
    cap = min(cap, _round_up(T, GROUP))
    chunk = min(chunk, _round_up(cap, GROUP))
    return _round_up(cap, chunk)


def make_bins(setup, extra_f, n2: int, n3: int, h: int, w: int,
              cap: int | None = None, spans=None) -> BinnedTris:
    """The bins raster_attrs_bins rasterizes: raster_attrs_pallas's cap
    arithmetic (_bins_cap, so the bins have JAX's shapes), then bin_pairs
    with spans = (m_x, m_y), or bin_triangles without."""
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by tile "
                         f"{TILE_H}x{TILE_W}")
    if extra_f.shape[1] != 3 * (n2 + n3):
        raise ValueError(f"{extra_f.shape[1]} attribute channels for "
                         f"n2={n2}, n3={n3}")
    cap = _bins_cap(setup.A.shape[0], cap)
    if spans is not None:
        return bin_pairs(setup, h, w, cap, spans[0], spans[1],
                         extra_f=extra_f)
    return bin_triangles(setup, h, w, cap, extra_f=extra_f)


def raster_attrs_bins(setup, extra_f, n2: int, n3: int, h: int, w: int,
                      cap: int | None = None, spans=None):
    """Rasterize + interpolate attribute planes through the bins
    (rustexp_tpu/ops/raster_pallas.py:423, raster_attrs_pallas).

    ``setup`` is a stacked TriSetup, ``extra_f`` f32 [T, 3*(n2+n3)]
    laid out [n2 x q0][n2 x q10][n2 x q20][n3 x qb1][n3 x qb2][n3 x qb0].
    Returns (z [h, w], mask bool [h, w], lin tuple of n2+n3 f32 [h, w]
    planes, overflow bool []); the planes still need the perspective
    divide by the first. ``overflow`` means a bin exceeded cap or a
    triangle its span budget: triangles were dropped, re-bin. CUDA
    tensors launch kernel B2, CPU tensors take the plain version.
    """
    bins = make_bins(setup, extra_f, n2, n3, h, w, cap, spans)
    args = (bins.counts, bins.setup_i, bins.setup_f, n2, n3, h, w)
    dev = bins.setup_f.device
    if dev.type == "cuda":
        z, slot, lin = raster_attrs_bins_cuda(*args)
    elif dev.type == "cpu":
        z, slot, lin = raster_attrs_bins_plain(*args)
    else:
        raise ValueError(f"no raster path for device {dev}")
    return z, slot >= 0, tuple(lin), bins.overflow


@functools.cache
def _b3_kernel():
    """The built kernel library and kernel B3's C entry, typed once."""
    lib = load_kernel_lib("raster_bins")
    fn = lib.lib.rb_bins_gbuffer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return lib, fn


def raster_gbuffer_bins_cuda(counts, setup_i, setup_f, h: int, w: int):
    """Launch kernel B3 (csrc/raster_bins.cu) -> (z, slot, b) with z and
    slot [h, w] and b [3, h, w]; every pixel is written, the clear where
    no slot wins. Only setup_f's channels 0-6 are read.

    ``raster_gbuffer_bins_cuda.launches`` counts the launches.
    """
    dev = setup_f.device
    n_tiles, cap, n_ich = setup_i.shape
    for name, t, dt in (("counts", counts, torch.int32),
                        ("setup_i", setup_i, torch.int32),
                        ("setup_f", setup_f, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"kernel B3 runs on CUDA tensors, got {dev}")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by {TILE_H}x{TILE_W}")
    if (counts.shape != (n_tiles,) or n_ich != _I_CH
            or n_tiles != (h // TILE_H) * (w // TILE_W)
            or setup_f.dim() != 3 or setup_f.shape[:2] != (n_tiles, cap)
            or setup_f.shape[2] < _F_CH):
        raise ValueError(f"bad bins shapes: counts {tuple(counts.shape)}, "
                         f"setup_i {tuple(setup_i.shape)}, setup_f "
                         f"{tuple(setup_f.shape)} for a {h}x{w} frame")
    lib, fn = _b3_kernel()
    z = torch.empty((h, w), dtype=torch.float32, device=dev)
    slot = torch.empty((h, w), dtype=torch.int32, device=dev)
    b = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    rc = fn(ptr(counts), ptr(setup_i), ptr(setup_f), ptr(z), ptr(slot),
            ptr(b), n_tiles, cap, setup_f.shape[2], TILE_H, TILE_W, h, w,
            stream_ptr(dev))
    lib.check(rc, "kernel B3 (rb_bins_gbuffer)")
    raster_gbuffer_bins_cuda.launches += 1
    return z, slot, b


raster_gbuffer_bins_cuda.launches = 0


def raster_gbuffer_pallas(setup, h: int, w: int, cap: int | None = None,
                          chunk: int = 512):
    """Rasterize a stacked TriSetup to a G-buffer through the bins
    (rustexp_tpu/ops/raster_pallas.py:221) -> (GBuffer, overflow).

    The name is the JAX package's. The frame must be whole 32x128 tiles
    (raster_xla.raster_gbuffer_xla takes any size). ``cap`` is the static
    bin capacity, rounded as JAX rounds it with ``chunk``; ``overflow``
    is True when a bin exceeded it and triangles were dropped (re-bin with
    a larger cap). Equal to raster_gbuffer_xla when nothing overflows:
    bins keep submission order and the race keeps the earlier slot on a
    tie. CUDA tensors launch kernel B3, CPU tensors take the plain version.
    """
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {h}x{w} not divisible by tile "
                         f"{TILE_H}x{TILE_W}")
    cap = _bins_cap(setup.A.shape[0], cap, chunk)
    bins = bin_triangles(setup, h, w, cap)
    args = (bins.counts, bins.setup_i, bins.setup_f, h, w)
    dev = bins.setup_f.device
    if dev.type == "cuda":
        z, slot, b = raster_gbuffer_bins_cuda(*args)
    elif dev.type == "cpu":
        z, slot, b = raster_gbuffer_bins_plain(*args)
    else:
        raise ValueError(f"no raster path for device {dev}")
    # winning bin slot -> triangle id, one flat gather (raster_pallas.py:286)
    i32 = dict(dtype=torch.int32, device=dev)
    ys = torch.arange(h, **i32)[:, None]
    xs = torch.arange(w, **i32)[None, :]
    tile = _fdiv(ys, TILE_H) * (w // TILE_W) + _fdiv(xs, TILE_W)
    flat = (tile * cap + slot.clamp(min=0)).reshape(-1).long()
    tid = torch.where(slot >= 0, bins.ids.reshape(-1)[flat].reshape(h, w), -1)
    return GBuffer(z=z, tid=tid.to(torch.int32),
                   b=torch.stack(tuple(b), dim=-1)), bins.overflow

"""Band-sharded rendering on torch.distributed.

Port of rustexp_tpu/parallel/raster_shard.py. Two band renderers, one
band per rank (see the package docstring for how the mesh maps onto
ranks):

* The G-buffer band path (make_sharded_render, render_frame_sharded,
  :31-114). Every rank transforms all vertices (cheap), sets up the
  triangles with the integer band translation y_shift applied after the
  global 28.4 snap (so its band's edges are the full frame's rows, bit
  for bit), rasterizes its band to a G-buffer (raster_gbuffer_xla, or
  kernel B3 through raster_gbuffer_pallas) and shades it against its
  slice of the background gradient. The barycentrics do not depend on
  the translation, so the shade interpolates the untranslated vertex
  attributes.
* The flat-queue band path (:117-440), the production raster: each rank
  builds (or is given) its band's queue and runs kernel B1
  (raster_attrs_queue) on it, then the compacted shade at global rows.
  layout="bands" gives rank r the contiguous rows of band r through the
  same post-snap translation; layout="cyclic" gives it every D-th tile
  row (build_queue's row_stride/row_offset on the untranslated setup),
  which spreads a centre-heavy mesh's pairs evenly over the ranks.
  Either way a rank's rows equal the same rows of the one-rank queue
  frame bit for bit; a cyclic frame's gathered bands are put back in
  order by deinterleave_rows. Queue caps are the maximum over every eye
  and band, so every rank runs the same shapes: band_queue_caps takes it
  over all bands in one process (group=None) or all-reduces each rank's
  own with MAX.

all_gather_into_tensor stitches the bands in rank order, and the
overflow and stale flags are all-reduced with MAX. ``group=None``
renders the whole frame as one band in this process, with no
collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.raster_bins import raster_gbuffer_pallas
from ..ops.raster_queue import (TILE_H, build_queue, queue_stats,
                                raster_attrs_queue, suggest_queue_config)
from ..ops.raster_setup import setup_triangles, setup_triangles_planar
from ..ops.raster_xla import raster_gbuffer_xla
from ..raster import pipeline as pp
from ..raster.shade import shade_pack
from . import collectives as coll


def render_band(scene: pp.Scene, eye, tick, *, band: int, n_bands: int,
                w: int, h: int, per_pixel: bool = False, shader_idx: int = 5,
                bg_idx: int = 0, backend: str = "xla"):
    """Rows [band * h/n_bands, (band + 1) * h/n_bands) of the w x h frame
    (rustexp_tpu/parallel/raster_shard.py:58-92) -> (fb int32 ABGR bits
    [h/n_bands, w], overflow bool []). ``backend`` is "xla" (the oracle)
    or "pallas" (kernel B3 on the card, its plain version on the CPU);
    overflow is always False for "xla"."""
    if h % n_bands:
        raise ValueError(f"frame height {h} not divisible by {n_bands} bands")
    if backend not in ("xla", "pallas"):
        raise ValueError(f"band backend {backend!r}: 'xla' or 'pallas'")
    band_h = h // n_bands
    y0 = band * band_h
    vp, world, n_world = pp.transform_vertices(scene, eye, w, h)
    colors = scene.colors
    if not per_pixel:
        colors = pp.sh.shader_fn(shader_idx)(
            world, n_world, scene.colors, pp._host_eye(eye).to(vp.device),
            tick, scene.cm)
    setup = setup_triangles(vp, scene.tris, w, band_h, y_shift=y0)
    if backend == "pallas":
        gb, overflow = raster_gbuffer_pallas(setup, band_h, w)
    else:
        gb = raster_gbuffer_xla(setup, band_h, w)
        overflow = torch.zeros((), dtype=torch.bool, device=vp.device)
    bg = pp.background(bg_idx, w, band_h, vp.device, y0=y0, full_h=h)
    fb = pp.shade_gbuffer(gb, scene, vp, world, n_world, colors, eye, tick,
                          per_pixel=per_pixel, shader_idx=shader_idx,
                          bg_fb=bg)
    return fb, overflow


def make_sharded_render(group: dist.ProcessGroup | None = None, *, w: int,
                        h: int, per_pixel: bool = False, shader_idx: int = 5,
                        bg_idx: int = 0, backend: str = "xla",
                        return_overflow: bool = False):
    """A (scene, eye, tick) -> fb renderer over the ranks of `group`
    (rustexp_tpu/parallel/raster_shard.py:31): rank r renders band r of
    the group's size, and every rank returns the whole uint32 [h, w]
    frame. With return_overflow it also returns the MAX over the ranks of
    the bins' overflow (backend "pallas"): re-bin when it is True."""
    if group is None:
        n_bands, band = 1, 0
    else:
        n_bands, band = dist.get_world_size(group), dist.get_rank(group)
    if h % n_bands:
        raise ValueError(f"frame height {h} not divisible by {n_bands} ranks")

    def render(scene: pp.Scene, eye, tick):
        fb, overflow = render_band(
            scene, eye, tick, band=band, n_bands=n_bands, w=w, h=h,
            per_pixel=per_pixel, shader_idx=shader_idx, bg_idx=bg_idx,
            backend=backend)
        if group is not None:
            frame = fb.new_empty((h, w))
            dist.all_gather_into_tensor(frame, fb.contiguous(), group=group)
            flag = overflow.to(torch.int32).reshape(1)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            fb, overflow = frame, flag[0] > 0
        fb = fb.view(torch.uint32)
        return (fb, overflow) if return_overflow else fb

    return render


def render_frame_sharded(scene: pp.Scene, eye, tick,
                         group: dist.ProcessGroup | None = None, **kw):
    """One frame through make_sharded_render(group, **kw)
    (rustexp_tpu/parallel/raster_shard.py:111)."""
    return make_sharded_render(group, **kw)(scene, eye, tick)


# ---------------------------------------------------------------------------
# The flat-queue band path
# ---------------------------------------------------------------------------

LAYOUTS = ("bands", "cyclic")


def _check_layout(h: int, n_dev: int, layout: str) -> int:
    """band_h for an h-row frame over n_dev ranks in `layout`; raises
    where JAX raises (:244-249)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not one of {LAYOUTS}")
    if h % n_dev:
        raise ValueError(f"frame height {h} not divisible by {n_dev} devices")
    if layout == "cyclic" and (h // TILE_H) % n_dev:
        raise ValueError(
            f"{h // TILE_H} tile rows not divisible by {n_dev} devices")
    return h // n_dev


def interleave_y_rows(band_h: int, n_dev: int, dev: int,
                      tile_h: int = TILE_H) -> torch.Tensor:
    """int32 [band_h] (CPU): the global pixel row of each local row of
    rank `dev`'s cyclic band (:125). Rank dev owns the global tile rows g
    with g % n_dev == dev; local row ly lies in local tile row
    ly // tile_h, so at global row (ly // tile_h * n_dev + dev) * tile_h
    + ly % tile_h."""
    ly = torch.arange(band_h, dtype=torch.int32)
    return (ly // tile_h * n_dev + dev) * tile_h + ly % tile_h


def deinterleave_rows(fb: torch.Tensor, n_dev: int,
                      tile_h: int = TILE_H) -> torch.Tensor:
    """The frame in row order from the rank-major stack of cyclic bands
    (:137): row block d * band_h + lt * tile_h holds global tile row
    lt * n_dev + d."""
    h = fb.shape[0]
    x = fb.reshape((n_dev, h // n_dev // tile_h, tile_h) + tuple(fb.shape[1:]))
    return x.transpose(0, 1).reshape(fb.shape)


def _band_setup(scene: pp.Scene, eye, *, w: int, h: int, n_dev: int,
                band: int, layout: str):
    """The planar setup band `band` rasterizes: the band_h rows translated
    after the snap ("bands"), or the whole frame ("cyclic": its queue
    carries global tile rows)."""
    band_h = _check_layout(h, n_dev, layout)
    xs, ys, zs, _, _, _ = pp.transform_corners_planar(scene, eye, w, h)
    if layout == "cyclic":
        return setup_triangles_planar(xs, ys, zs, w, h)
    return setup_triangles_planar(xs, ys, zs, w, band_h, y_shift=band * band_h)


def _band_stats(setup, *, w: int, h: int, n_dev: int, band: int,
                layout: str) -> torch.Tensor:
    """queue_stats of one band as int64 [5] on the setup's device."""
    if layout == "cyclic":
        st = queue_stats(setup, h, w, row_stride=n_dev, row_offset=band)
    else:
        st = queue_stats(setup, h // n_dev, w)
    return torch.stack([x.to(torch.int64) for x in st])


def band_queue_caps(scene: pp.Scene, eyes, *, w: int, h: int, n_dev: int,
                    layout: str = "bands", group=None) -> tuple:
    """One set of static queue caps (s_cap, m_y, m_x, t_cap) for every
    (eye, band) pair (:151): suggest_queue_config of the maximum of each
    queue_stats entry. group=None measures all n_dev bands in this
    process; with a group each rank measures its own band and the maxima
    are all-reduced, the same numbers. One read back to the host."""
    n, rank = coll.world(group)
    if group is not None and n != n_dev:
        raise ValueError(f"{n_dev} bands over a group of {n} ranks")
    bands = range(n_dev) if group is None else (rank,)
    st = torch.stack([
        _band_stats(_band_setup(scene, e, w=w, h=h, n_dev=n_dev, band=d,
                                layout=layout),
                    w=w, h=h, n_dev=n_dev, band=d, layout=layout)
        for e in eyes for d in bands]).amax(dim=0)
    agg = coll.pmax(st, group).tolist()
    return suggest_queue_config(tuple(agg[:4]))


def _queue_of_setup(setup, caps, *, w: int, h: int, n_dev: int, band: int,
                    layout: str):
    """Band `band`'s queue from its setup (_band_setup's) at `caps`: the
    translated band's build ("bands") or the interleaved build of the
    whole frame ("cyclic"), at build_queue's default order and shade
    width."""
    s_cap, m_y, m_x, t_cap = caps
    if layout == "cyclic":
        return build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                           t_cap=t_cap, row_stride=n_dev, row_offset=band)
    return build_queue(setup, h // n_dev, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                       t_cap=t_cap)


def build_band_queue(scene: pp.Scene, eye, caps, *, w: int, h: int,
                     n_dev: int, band: int, layout: str = "bands"):
    """Band `band`'s flat queue at the given caps (one rank's part of
    build_band_queues)."""
    setup = _band_setup(scene, eye, w=w, h=h, n_dev=n_dev, band=band,
                        layout=layout)
    return _queue_of_setup(setup, caps, w=w, h=h, n_dev=n_dev, band=band,
                           layout=layout)


def build_band_queues(scene: pp.Scene, eye, *, w: int, h: int, n_dev: int,
                      margin: float = 1.3, layout: str = "bands") -> list:
    """Every band's queue at caps unified over the bands, in one process
    (:196, which stacks them on a leading axis; here a list, band d at
    index d). A rank builds only its own: build_band_queue with
    band_queue_caps(..., group=group)."""
    caps = band_queue_caps(scene, [eye], w=w, h=h, n_dev=n_dev, layout=layout)
    return [build_band_queue(scene, eye, caps, w=w, h=h, n_dev=n_dev, band=d,
                             layout=layout) for d in range(n_dev)]


def queue_band(scene: pp.Scene, queue, eye, tick, *, band: int, n_dev: int,
               w: int, h: int, per_pixel: bool = False, shader_idx: int = 5,
               bg_idx: int = 0, layout: str = "bands", caps=None):
    """Band `band` of the flat-queue frame (:264-350) -> (fb int32
    [h/n_dev, w], stale bool []): the planar transform, the band's setup,
    its queue (the given one, or built here from this frame's setup when
    `caps` is given: the moving camera), the V or P attribute channels,
    kernel B1 (raster_attrs_queue), and the shade at global rows.
    `stale` is this band's alone."""
    band_h = _check_layout(h, n_dev, layout)
    cyclic = layout == "cyclic"
    y0 = band * band_h
    y_rows = interleave_y_rows(band_h, n_dev, band) if cyclic else None
    colors = None if per_pixel else pp.vertex_colors(scene, eye, tick, w, h,
                                                     shader_idx)
    setup, extra, n2, n3 = pp.queue_attr_channels(
        scene, colors, eye, w, h, per_pixel=per_pixel, ray_world=True,
        band_h=None if cyclic else band_h, y_shift=0 if cyclic else y0)
    if caps is not None:
        queue = _queue_of_setup(setup, caps, w=w, h=h, n_dev=n_dev,
                                band=band, layout=layout)
    z, mask, lin, stale = raster_attrs_queue(queue, setup, extra, n2, n3,
                                             band_h, w)
    bg = pp.background(bg_idx, w, band_h, z.device, y0=y0, full_h=h,
                       y_rows=y_rows)
    if per_pixel:
        fb = pp._shade_compacted(queue.rows, scene, z, mask, lin, eye, tick,
                                 shader_idx, bg, w, band_h,
                                 block_w=queue.shade_w, ray_world=True,
                                 y0=y0, full_h=h, y_rows=y_rows)
    else:
        fb = shade_pack(mask, z, lin, bg, scene.cm, eye, tick,
                        shader_idx=shader_idx, per_pixel=False,
                        ray_world=False)
    return fb, stale


def _queue_band_core(group, *, w: int, h: int, per_pixel: bool,
                     shader_idx: int, bg_idx: int, caps=None,
                     layout: str = "bands"):
    """(scene, queue, eye, tick) -> (fb uint32 [h, w], stale) on each rank
    of `group` (:233): its band through queue_band, the bands gathered in
    rank order (cyclic: rank-major, deinterleave_rows orders them), the
    stale flag all-reduced with MAX."""
    n_dev, band = coll.world(group)
    _check_layout(h, n_dev, layout)

    def render(scene, queue, eye, tick):
        fb, stale = queue_band(scene, queue, eye, tick, band=band,
                               n_dev=n_dev, w=w, h=h, per_pixel=per_pixel,
                               shader_idx=shader_idx, bg_idx=bg_idx,
                               layout=layout, caps=caps)
        return (coll.all_gather_cat(fb, group).view(torch.uint32),
                coll.any_ranks(stale, group))

    return render


def make_sharded_queue_render(group, scene: pp.Scene, eye, *, w: int,
                              h: int, per_pixel: bool = False,
                              shader_idx: int = 5, bg_idx: int = 0,
                              layout: str = "bands"):
    """(scene, queue, eye, tick) -> (fb, stale) over the flat-queue kernel,
    one band per rank of `group` (:352). `queue` is the rank's own band
    queue (build_band_queue; cache it across frames like the one-rank
    queue, built in the same `layout`); `stale` is True when any rank's
    queue no longer covers the frame. Every rank returns the whole frame;
    a cyclic frame comes back rank-major (deinterleave_rows). `scene` and
    `eye` are unused, as in the JAX signature."""
    return _queue_band_core(group, w=w, h=h, per_pixel=per_pixel,
                            shader_idx=shader_idx, bg_idx=bg_idx,
                            layout=layout)


def make_sharded_queue_render_moving(group, scene: pp.Scene, cap_eyes, *,
                                     w: int, h: int, per_pixel: bool = False,
                                     shader_idx: int = 5, bg_idx: int = 0,
                                     layout: str = "bands"):
    """(scene, eye, tick) -> (fb, stale) with each rank rebuilding its
    band's queue from every frame's setup (:396): the sharded moving
    camera. The caps are band_queue_caps over `cap_eyes` (sample the
    camera path); stale True means the camera left them (make the
    renderer again with wider cap_eyes). Every rank returns the whole
    frame, as make_sharded_queue_render does."""
    n_dev, _ = coll.world(group)
    caps = band_queue_caps(scene, cap_eyes, w=w, h=h, n_dev=n_dev,
                           layout=layout, group=group)
    core = _queue_band_core(group, w=w, h=h, per_pixel=per_pixel,
                            shader_idx=shader_idx, bg_idx=bg_idx, caps=caps,
                            layout=layout)
    return lambda scene, eye, tick: core(scene, None, eye, tick)

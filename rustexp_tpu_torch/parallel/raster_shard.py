"""Band-sharded G-buffer rendering on torch.distributed.

Port of the G-buffer band path of rustexp_tpu/parallel/raster_shard.py
(make_sharded_render and render_frame_sharded, :31-114). The frame is cut
into horizontal bands, one per rank. Every rank transforms all vertices
(cheap), sets up the triangles with the integer band translation y_shift
applied after the global 28.4 snap (so its band's edges are the full
frame's rows, bit for bit), rasterizes its band to a G-buffer
(raster_gbuffer_xla, or kernel B3 through raster_gbuffer_pallas) and
shades it against its slice of the background gradient. The barycentrics
do not depend on the translation, so the shade interpolates the
untranslated vertex attributes. all_gather_into_tensor stitches the bands
in rank order, and the bins' overflow is all-reduced with MAX.

The caller owns the process group: it gives
torch.distributed.init_process_group an address, the world size and each
rank (NCCL between cards, gloo on the CPU). ``group=None`` renders the
whole frame as one band in this process, with no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.raster_bins import raster_gbuffer_pallas
from ..ops.raster_setup import setup_triangles
from ..ops.raster_xla import raster_gbuffer_xla
from ..raster import pipeline as pp


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

"""The raster route: which structure a Fill frame renders through, and
that structure, built at an eye.

Each structure's kernel takes frames of its own whole tiles: QUEUE, the
flat queue (kernel B1), ops/raster_queue's 16x128; BINS, the [nT, cap]
bins (kernel B2), ops/raster_bins' 32x128; ORACLE, the G-buffer oracle
(no kernel, nothing built), any frame. route() picks one, build() builds
it (again at a new eye when a frame reports it stale), and
raster/pipeline.py's render_frame dispatches on it. The kinds are the
backend names callers pass ("auto" routes by triangle count), as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import trace
from ..ops import raster_bins as rb
from ..ops.raster_queue import (SHADE_W, TILE_H, TILE_W, build_queue,
                                choose_shade_w, read_queue_stats,
                                suggest_queue_config)
from ..ops.raster_setup import setup_triangles, setup_triangles_planar
from . import pipeline as pp

QUEUE, BINS, ORACLE = "queue", "pallas", "xla"
BACKENDS = ("auto", QUEUE, BINS, ORACLE)

QUEUE_MIN_TRIS = 1000  # "auto" takes the flat queue from this many triangles

_TILES = {QUEUE: (TILE_H, TILE_W), BINS: (rb.TILE_H, rb.TILE_W),
          ORACLE: (1, 1)}


def accepts(kind: str, w: int, h: int) -> bool:
    """Whether `kind`'s kernel takes a w x h frame: whole tiles of its
    own (the oracle takes any frame)."""
    th, tw = _TILES[kind]
    return h % th == 0 and w % tw == 0


def route(n_tris: int, w: int, h: int, backend: str = "auto") -> str:
    """The kind of structure that renders a w x h frame of an n_tris mesh.

    "auto" asks for QUEUE at >= QUEUE_MIN_TRIS triangles, else BINS;
    "queue", "pallas" and "xla" ask for QUEUE, BINS and ORACLE. A kind
    whose kernel does not take the frame gives way to ORACLE."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "auto":
        backend = QUEUE if n_tris >= QUEUE_MIN_TRIS else BINS
    return backend if accepts(backend, w, h) else ORACLE


class Structure(NamedTuple):
    """What a Fill frame renders through: its kind and the kind's data, a
    Queue (QUEUE), the bins' (cap, spans, rows_cap) (BINS; None bins
    densely, at capacity T) or None (ORACLE)."""

    kind: str
    data: object = None

    def describe(self) -> dict:
        """The kind, as its backend name, and the structure's sizes."""
        if self.kind == QUEUE:
            return {"backend": QUEUE, "queue_order": self.data.order,
                    "shade_w": self.data.shade_w}
        if self.kind == BINS:
            cap, spans, rows_cap = self.data
            return {"backend": BINS, "cap": cap, "spans": list(spans),
                    "rows_cap": rows_cap}
        return {"backend": ORACLE}


def build(scene: pp.Scene, kind: str, eye, w: int, h: int, *,
          per_pixel: bool = True, shade_w: int | None = None) -> Structure:
    """`kind`'s structure for `scene` at `eye` (and at a new eye, when a
    frame reports it stale): suggest_binning's bins, nothing for the
    oracle, or the flat queue (rustexp_tpu/raster/pipeline.py:948
    build_scene_queue): one read of queue_stats for queue_caps, then
    build_queue with its "auto" order, from the same planar setup as the
    frame's, so no triangle can snap into a tile the queue never
    enumerated. The span structure.queue holds the queue's build."""
    if kind == QUEUE:
        with trace.span("structure.queue"):
            setup = queue_setup(scene, eye, w, h)
            caps = queue_caps([read_queue_stats(setup, h, w)],
                              per_pixel=per_pixel, shade_w=shade_w)
            return Structure(QUEUE, build_queue(setup, h, w, **caps))
    if kind == BINS:
        return Structure(BINS, suggest_binning(scene, eye, w, h))
    return Structure(ORACLE)


def queue_setup(scene: pp.Scene, eye, w: int, h: int):
    """The frame's planar setup, which the queue is built from: kernel T
    without its channels on the card, the plain chain on the CPU."""
    if scene.cp3.device.type == "cuda":
        return pp.queue_setup_card(scene, eye, w, h)
    xs, ys, zs, _, _, _ = pp.transform_corners_planar(scene, eye, w, h)
    return setup_triangles_planar(xs, ys, zs, w, h)


def queue_caps(stats, *, per_pixel: bool = True, shade_w: int | None = None,
               rebuild_per_frame: bool = False) -> dict:
    """build_queue's static caps for the queue_stats of one eye or of
    several along a camera path: the largest of each entry, the
    compacted-shade width choose_shade_w picks (or `shade_w`), and
    suggest_queue_config's margins. -> {s_cap, m_y, m_x, t_cap, shade_w}"""
    agg = tuple(max(st[j] for st in stats) for j in range(5))
    if shade_w is None:
        shade_w = choose_shade_w(agg[3], agg[4], per_pixel=per_pixel,
                                 rebuild_per_frame=rebuild_per_frame)
    occ = agg[3] if shade_w == SHADE_W else agg[4]
    s_cap, m_y, m_x, t_cap = suggest_queue_config(agg[:3] + (occ,))
    return dict(s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap, shade_w=shade_w)


def queue_at(scene: pp.Scene, eye, w: int, h: int, caps: dict) -> Structure:
    """The flat queue at `eye` with fixed caps (queue_caps' over a camera
    path), no host read: the moving camera's build every frame. The span
    structure.queue holds it."""
    with trace.span("structure.queue"):
        return Structure(QUEUE, build_queue(queue_setup(scene, eye, w, h),
                                            h, w, **caps))


def _bin_stats(scene: pp.Scene, eye, w: int, h: int):
    """(largest bin, max span_x, max span_y, occupied SHADE_W blocks) as
    0-d tensors (rustexp_tpu/raster/pipeline.py:872).

    A block (y, bx) can hold coverage only if some valid triangle's
    clipped AABB meets it: one [h, T] x [T, ntx] product of 0/1 matrices.
    Its sums are exact in float32 (and in TF32, were it switched on), so
    the > 0 test does not depend on the matmul precision.
    """
    vp, _, _ = pp.transform_vertices(scene, eye, w, h)
    setup = setup_triangles(vp, scene.tris, w, h)
    sx, sy = rb.max_spans(setup, h, w)
    ntx = -(-w // SHADE_W)
    i32 = dict(dtype=torch.int32, device=setup.valid.device)
    ys = torch.arange(h, **i32)
    occ_y = ((ys[:, None] >= setup.min_y[None, :])
             & (ys[:, None] < setup.max_y[None, :]))           # [h, T]
    tx0 = torch.arange(ntx, **i32) * SHADE_W
    occ_x = ((tx0[None, :] < setup.max_x[:, None])
             & (tx0[None, :] + SHADE_W > setup.min_x[:, None])
             & setup.valid[:, None])                           # [T, ntx]
    occ = torch.matmul(occ_y.to(torch.float32), occ_x.to(torch.float32)) > 0
    return rb.max_bin_count(setup, h, w), sx, sy, occ.sum(dtype=torch.int32)


def suggest_binning(scene: pp.Scene, eye, w: int, h: int,
                    margin: float = 1.3):
    """(cap, (m_x, m_y), rows_cap) for the bins, one host read
    (rustexp_tpu/raster/pipeline.py:895).

    The span margin (+1 tile each way) absorbs camera motion; bin_pairs
    still reports ``overflow`` if a frame exceeds it. rows_cap bounds
    the occupied shade blocks (the compacted shade) with the same
    margin, or is None when >= 75% of the frame's blocks can be occupied
    (compaction then costs more than the shade it skips). The span
    structure.bins holds the device work and its read.
    """
    with trace.span("structure.bins"):
        stats = torch.stack(_bin_stats(scene, eye, w, h))
        with trace.span("sync.read.bin_stats"):
            mc, sx, sy, rc = stats.tolist()
    need = max(512, int(mc * margin))
    cap = (need + 511) // 512 * 512
    ntx = -(-w // SHADE_W)
    rows_cap = min(h * ntx, max(64, (int(rc * margin) + 63) // 64 * 64))
    if rows_cap >= (h * ntx * 3) // 4:
        rows_cap = None
    return cap, (sx + 1, sy + 1), rows_cap


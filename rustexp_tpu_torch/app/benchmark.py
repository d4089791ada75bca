"""The benchmarks on the card: the 12-scene rasterizer suite, GoL and N-body.

Port of rustexp_tpu/app/benchmark.py (SCENES, the scene constants,
FRAMES_PER_DISPATCH, QUEUE_MIN_TRIS, _run_stats, bench_scene, run_suite,
the moving-camera benches bench_scene_moving and
bench_scene_moving_amortized, bench_gol and bench_nbody). The scene
matches the reference's rast_benchmark (rasterizer.rs:1781-1884):
512x512, Fill, shader 5 (CMRefl), envmap 0, tick 0. Work is timed with
CUDA events around a batch (FRAMES_PER_DISPATCH back-to-back frames with
JAX's checksum each, a camera path's k frames, or one call of k
generations or steps); a device without CUDA is refused, never measured
on the CPU instead. The JAX package's TPU-only columns (its stored TPU
times and the "vs-own" ratio) are not carried over.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..assets import cubemap, mesh
from ..core import prng, trace
from ..ops import gol_bits, gol_stencil, nbody_bh, nbody_forces, nbody_pallas
from ..ops.raster_queue import (SHADE_W, TILE_H, TILE_W, build_queue,
                                choose_shade_w, read_queue_stats,
                                resolve_order, suggest_queue_config)
from ..ops.raster_setup import (dilate_setup_planar, setup_triangles_planar,
                                signed_area2)
from ..raster import camera, pipeline as pp
from ..runtime import device as pick_device

# (label, mesh_idx, per_pixel, reference_us) — rasterizer.rs:1791-1804
SCENES = (
    ("KillerooV", 0, False, 1812),
    ("HeadV", 1, False, 2500),
    ("HandV", 4, False, 910),
    ("TorusKnotV", 6, False, 1287),
    ("CubeV", 9, False, 1107),
    ("CornellBoxV", 11, False, 1326),
    ("KillerooP", 0, True, 2435),
    ("HeadP", 1, True, 3841),
    ("HandP", 4, True, 1689),
    ("TorusKnotP", 6, True, 3132),
    ("CubeP", 9, True, 3461),
    ("CornellBoxP", 11, True, 3786),
)

W = H = 512
SHADER = 5  # CMRefl
ENV = 0     # Grace
TICK = 0.0
REF_TOTAL_US = 27286  # rasterizer.rs:1829-1834

# Meshes below this triangle count take the [nT, cap] bins (kernel B2);
# at or above it, the flat queue (kernel B1).
QUEUE_MIN_TRIS = 1000

# bench_scene's frames a run, back to back between one pair of CUDA events
# (JAX's frames a dispatch, rustexp_tpu/app/benchmark.py:55)
FRAMES_PER_DISPATCH = 1024

# bench_scene's backends, as the JAX bench takes them
BACKENDS = ("auto", "queue", "pallas", "xla")


def _run_stats(run, runs: int, per: float) -> dict:
    """Call run() `runs` times; run returns the seconds it took. Per-unit
    seconds {best, median, spread_pct, n_runs}, spread =
    (max - min) / median * 100, so the noise floor travels with the number."""
    ts = sorted(run() / per for _ in range(max(1, runs)))
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    spread = (ts[-1] - ts[0]) / med * 100 if med else 0.0
    return {"best": ts[0], "median": med, "spread_pct": spread, "n_runs": n}


def _card(device) -> torch.device:
    device = pick_device(device)
    if device.type != "cuda":
        raise ValueError(f"the benchmark times the card; got device {device}")
    return device


def _event_seconds(fn) -> float:
    """Seconds of fn()'s device work, by CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def scene_frame(mesh_idx: int, per_pixel: bool, device: torch.device,
                backend: str = "auto", shade_w: int | None = None):
    """One bench scene on `device` -> (frame, structure, mesh, envmap).

    `backend` is the JAX bench's (rustexp_tpu/app/benchmark.py:114-121):
    "auto" takes the flat queue for meshes of >= QUEUE_MIN_TRIS triangles,
    else the bins; "queue" builds a flat queue (compacted-shade width
    `shade_w`, else choose_shade_w's), "pallas" a suggest_binning config
    for the bins, "xla" no structure (the G-buffer oracle, no kernel). The
    structure is built once and reused, as the renderer does for a
    temporally coherent camera. frame() renders one frame, the span
    ``frame``, and returns (fb, stale), the flag a device tensor (the
    cached queue went stale or the bins overflowed); each frame pays
    transform, setup, binning or row gather, the raster kernel (B1 or
    B2), shading and pack. `structure` names the backend and its
    structure (queue order and shade_w, or cap, spans and rows_cap).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    m = mesh.get_mesh(mesh_idx)
    cm = cubemap.get_cm_set(ENV)
    scene = pp.make_scene(m, cm, device)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), TICK)
    if backend == "auto":
        backend = "queue" if m.num_tris >= QUEUE_MIN_TRIS else "pallas"
    kw = dict(backend=backend)
    structure = {"backend": backend}
    if backend == "queue":
        queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel,
                                     shade_w=shade_w)
        kw.update(raster_queue=queue)
        structure.update(queue_order=queue.order, shade_w=queue.shade_w)
    elif backend == "pallas":
        cap, spans, rows_cap = pp.suggest_binning(scene, eye, W, H)
        kw.update(raster_cap=cap, raster_spans=spans, raster_rows=rows_cap)
        structure.update(cap=cap, spans=list(spans), rows_cap=rows_cap)

    def frame() -> tuple[torch.Tensor, torch.Tensor]:
        with trace.span("frame"):
            return pp.render_frame(
                scene, eye, TICK, w=W, h=H, mode=pp.MODE_FILL,
                per_pixel=per_pixel, shader_idx=SHADER, bg_idx=0,
                show_cm=False, return_overflow=True, **kw)

    return frame, structure, m, cm


def frame_sum(fb: torch.Tensor, stale: torch.Tensor) -> torch.Tensor:
    """One frame's checksum before its 32-bit wrap: an int64 on fb's
    device. JAX reduces each frame to jnp.sum(fb, dtype=uint32) + stale
    (rustexp_tpu/app/benchmark.py:136); the sum of fb's int32 view differs
    from the uint32 sum by a multiple of 2^32, so wrap32 of this is JAX's."""
    return fb.view(torch.int32).sum(dtype=torch.int64) + stale


def wrap32(sums: torch.Tensor) -> torch.Tensor:
    """int64 sums -> their uint32 values (32-bit wraparound), as int64."""
    return sums & prng.MASK


def bench_scene(mesh_idx: int, per_pixel: bool, runs: int,
                backend: str = "auto", return_stats: bool = False,
                shade_w: int | None = None,
                device: torch.device | str | None = None):
    """Best per-frame seconds for one scene (scene_frame's route for
    `backend` and `shade_w`), or with return_stats its record.

    JAX's sampling (rustexp_tpu/app/benchmark.py:123-144): a run is
    FRAMES_PER_DISPATCH back-to-back frames, each reduced on the card to
    JAX's uint32 checksum (frame_sum, wrap32); one whole run warms up,
    then max(1, runs // 8) runs are timed, each between two CUDA events.
    A run's checksums stay on the card until its end event and are then
    read once, as JAX's np.asarray pull reads its scan's. A fixed eye
    renders one frame, so a run whose checksums differ raises, and so does
    a stale flag (ORed on the card, read after the runs) where JAX only
    folds it into the checksum. The record holds JAX's stats (best,
    median, spread_pct, n_runs), the frames a run and the frame's
    checksum, and names the card, the backend and its structure, and
    whether the mesh and envmap are the procedural stand-ins (assets
    absent) or the reference's.
    """
    device = _card(device)
    frame, structure, m, cm = scene_frame(mesh_idx, per_pixel, device,
                                          backend, shade_w)
    k = FRAMES_PER_DISPATCH
    stale_any = torch.zeros((), dtype=torch.bool, device=device)
    checksum = None

    def frames() -> torch.Tensor:
        nonlocal stale_any
        sums = []
        for _ in range(k):
            fb, stale = frame()
            stale_any = stale_any | stale
            sums.append(frame_sum(fb, stale))
        return wrap32(torch.stack(sums))

    def check(sums: torch.Tensor) -> None:
        nonlocal checksum
        got = set(sums.tolist())  # the run's one read of the card
        if checksum is not None:
            got.add(checksum)
        if len(got) != 1:
            raise RuntimeError(f"the frames of a fixed eye differ: "
                               f"checksums {sorted(got)}")
        checksum = got.pop()

    def run() -> float:
        out = []
        seconds = _event_seconds(lambda: out.append(frames()))
        check(out[0])
        return seconds

    check(frames())  # warm-up: a whole run (kernel builds, allocator growth)
    st = _run_stats(run, max(1, runs // 8), k)
    if bool(stale_any):
        raise RuntimeError("the cached raster structure went stale or "
                           "overflowed at a fixed eye")
    if not return_stats:
        return st["best"]
    return {
        "scene": _label(mesh_idx, per_pixel), **st, "frames_per_run": k,
        "checksum": checksum, "device": torch.cuda.get_device_name(device),
        **structure, **_assets(m, cm),
    }


def _label(mesh_idx: int, per_pixel: bool) -> str:
    return next((s[0] for s in SCENES
                 if s[1] == mesh_idx and s[2] == per_pixel),
                f"mesh{mesh_idx}{'P' if per_pixel else 'V'}")


def _assets(m, cm) -> dict:
    """The triangle count, and whether the mesh and the envmap are the
    procedural stand-ins (assets absent) or the reference's."""
    return {
        "triangles": m.num_tris,
        "mesh": "procedural stand-in" if m.name.endswith("(procedural)")
        else "reference asset",
        "envmap": "procedural stand-in" if cm.name.endswith("(procedural)")
        else "reference asset",
    }


def _tinted(speedup: float, text: str) -> str:
    """ANSI red/green outside the reference's +-1% tolerance band
    (rasterizer.rs:1813-1883: faster = green, slower = red)."""
    if not sys.stdout.isatty():
        return text
    if speedup >= 1.01:
        return f"\x1b[32m{text}\x1b[0m"
    if speedup <= 0.99:
        return f"\x1b[31m{text}\x1b[0m"
    return text


def run_suite(runs: int = 20, backend: str = "auto", verbose: bool = True,
              device: torch.device | str | None = None) -> dict:
    """All 12 SCENES through bench_scene -> the headline record
    (rustexp_tpu/app/benchmark.py:162).

    Like the JAX package's suite, each scene counts its best run's
    per-frame time; ``value`` is 12 x 512^2 pixels over their sum, and
    ``vs_baseline`` the reference CPU's 27,286 us over that sum.
    ``scene_us`` holds each scene's best and ``rows`` each full record,
    with its median, spread and stand-in flags. `verbose` prints JAX's
    per-scene table and total line, each tinted by its speedup over the
    reference CPU (JAX's "vs-own" column divides by a TPU's stored times
    and is left out).
    """
    rows = []
    for label, mesh_idx, per_pixel, ref_us in SCENES:
        rows.append(bench_scene(mesh_idx, per_pixel, runs, backend,
                                return_stats=True, device=device))
        if verbose:
            us = rows[-1]["best"] * 1e6
            sp = ref_us / us
            print(_tinted(sp, f"# {label:<12} {us:9.0f} us   ref "
                              f"{ref_us:6d} us   speedup x{sp:6.2f}"))
    total_s = sum(r["best"] for r in rows)
    mpix_s = len(rows) * W * H / total_s / 1e6
    sp = REF_TOTAL_US / (total_s * 1e6)
    if verbose:
        print(_tinted(sp, f"# total {total_s * 1e6:9.0f} us   ref "
                          f"{REF_TOTAL_US} us   speedup x{sp:.2f}   "
                          f"{mpix_s:.0f} Mpix/s"))
    return {
        "metric": "raster_suite_Mpix_per_s",
        "value": mpix_s,
        "unit": "Mpix/s",
        "vs_baseline": sp,
        "scene_us": {r["scene"]: r["best"] * 1e6 for r in rows},
        "device": rows[0]["device"],
        "rows": rows,
    }


# ---------------------------------------------------------------------------
# The moving camera (rustexp_tpu/app/benchmark.py:200-396): every frame of
# the mesh's own camera path rebuilds the queue, or, amortized, every
# rebuild_every frames from a dilated setup.
# ---------------------------------------------------------------------------


def path_eyes(mesh_idx: int, k: int, fps: float = 60.0) -> np.ndarray:
    """f32 [k, 3] on the host: the mesh's camera path at ticks i / fps,
    each eye rounded from camera_eye's float64 as the JAX bench rounds
    it. A host eye puts no read of the card into a frame."""
    cam = mesh.mesh_camera(mesh_idx)
    ticks = np.arange(k, dtype=np.float64) / fps
    return np.stack([camera.camera_eye(cam, t) for t in ticks]).astype(
        np.float32)


def moving_caps(scene: pp.Scene, eyes, per_pixel: bool,
                shade_w: int | None = None, w: int = W, h: int = H) -> dict:
    """build_queue's static caps for a camera path: the largest
    queue_stats over 8 of its eyes with suggest_queue_config's margins,
    and the shade width choose_shade_w picks for a rebuild every frame
    (or `shade_w`). The pre-pass reads the card once per eye sampled.
    Returns {s_cap, m_y, m_x, t_cap, shade_w}."""
    k = len(eyes)
    stats = [pp.scene_queue_stats(scene, eyes[i], w, h)
             for i in range(0, k, max(1, k // 8))]
    agg = tuple(max(st[j] for st in stats) for j in range(5))
    if shade_w is None:
        shade_w = choose_shade_w(agg[3], agg[4], rebuild_per_frame=True,
                                 per_pixel=per_pixel)
    occ = agg[3] if shade_w == SHADE_W else agg[4]
    s_cap, m_y, m_x, t_cap = suggest_queue_config(agg[:3] + (occ,))
    return dict(s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap, shade_w=shade_w)


def moving_frame(scene: pp.Scene, eye, caps: dict, per_pixel: bool,
                 w: int = W, h: int = H):
    """One frame of the moving camera -> (fb, overflow): transform ->
    setup_triangles_planar -> build_queue (order "auto", the path's
    caps) -> render_frame(backend="queue"). `overflow` is a device flag:
    the caps were exceeded."""
    with trace.span("structure.queue"):
        queue = build_queue(pp._queue_setup(scene, eye, w, h), h, w, **caps)
    return pp.render_frame(
        scene, eye, TICK, w=w, h=h, mode=pp.MODE_FILL, per_pixel=per_pixel,
        shader_idx=SHADER, bg_idx=0, show_cm=False, backend="queue",
        raster_queue=queue, return_overflow=True)


def _order(scene: pp.Scene, caps: dict, w: int = W, h: int = H) -> str:
    """The order build_queue's "auto" resolves for this scene at `caps`."""
    return resolve_order("auto", scene.tris.shape[0], caps["s_cap"],
                         caps["m_y"], caps["m_x"],
                         (h // TILE_H) * (w // TILE_W))


def bench_scene_moving(mesh_idx: int = 0, per_pixel: bool = True,
                       runs: int = 8, fps: float = 60.0, k: int = 256,
                       shade_w: int | None = None,
                       device: torch.device | str | None = None) -> dict:
    """Per-frame cost of a moving camera: the queue rebuilt every frame
    (rustexp_tpu/app/benchmark.py:200).

    Each of the k frames of the mesh's camera path (eyes at i / fps) runs
    moving_frame at caps from a pre-pass over 8 of its eyes (moving_caps).
    A warm-up pass and `runs` timed passes of the k frames, each between
    two CUDA events; the overflow flag accumulates on the card and is
    read once, at the end, and a set flag raises. The record keeps the
    JAX bench's keys (value in us per frame) and adds the card, the
    order build_queue resolved, the caps and the stand-in flags.
    """
    device = _card(device)
    m = mesh.get_mesh(mesh_idx)
    cm = cubemap.get_cm_set(ENV)
    scene = pp.make_scene(m, cm, device)
    eyes = path_eyes(mesh_idx, k, fps)
    caps = moving_caps(scene, eyes, per_pixel, shade_w)
    overflow = torch.zeros((), dtype=torch.bool, device=device)

    def frames() -> None:
        nonlocal overflow
        for e in eyes:
            overflow = overflow | moving_frame(scene, e, caps, per_pixel)[1]

    frames()  # warm-up: first-use kernel build and allocator growth
    st = _run_stats(lambda: _event_seconds(frames), runs, k)
    if bool(overflow):
        raise RuntimeError("the static queue caps overflowed along the "
                           "camera path")
    return {
        "metric": "raster_moving_camera_us_per_frame",
        "value": st["best"] * 1e6, "unit": "us", "frames": k,
        "scene": _label(mesh_idx, per_pixel),
        "us_median": st["median"] * 1e6, "spread_pct": st["spread_pct"],
        "n_runs": st["n_runs"],
        "device": torch.cuda.get_device_name(device),
        "queue_order": _order(scene, caps), **caps, **_assets(m, cm),
    }


def amortized_margins(scene: pp.Scene, eyes, rebuild_every: int,
                      safety: float = 1.5, w: int = W,
                      h: int = H) -> tuple[int, int]:
    """(dilate px, area margin) for a queue rebuilt every `rebuild_every`
    frames of the path `eyes`: the largest vertex displacement and
    |2*area| change between 8 sampled eyes, per frame, over a chunk's
    rebuild_every - 1 frames, times `safety`
    (rustexp_tpu/app/benchmark.py:320-343). Reads the card per eye."""
    k = len(eyes)
    stride = max(1, k // 8)
    disp = area_d = 0.0
    prev = None
    for i in range(0, k, stride):
        xs, ys, zs = pp.transform_corners_planar(scene, eyes[i], w, h)[:3]
        setup = setup_triangles_planar(xs, ys, zs, w, h)
        q = (xs.cpu().numpy(), ys.cpu().numpy(),
             signed_area2(setup).cpu().numpy())
        if prev is not None:
            disp = max(disp, float(np.abs(q[0] - prev[0]).max()),
                       float(np.abs(q[1] - prev[1]).max()))
            area_d = max(area_d, float(np.abs(q[2] - prev[2]).max()))
        prev = q
    dilate = int(np.ceil(disp / stride * (rebuild_every - 1) * safety)) + 1
    area_margin = int(np.ceil(area_d / stride * (rebuild_every - 1)
                              * safety)) + 16
    return dilate, area_margin


def amortized_caps(scene: pp.Scene, eyes, dilate: int, area_margin: int,
                   w: int = W, h: int = H) -> dict:
    """build_queue's static caps from the dilated setups' queue_stats over
    8 sampled eyes (rustexp_tpu/app/benchmark.py:345-358): the rows list
    at the fine SHADE_W, as the JAX bench builds it."""
    k = len(eyes)
    stats = []
    for i in range(0, k, max(1, k // 8)):
        s = dilate_setup_planar(pp._queue_setup(scene, eyes[i], w, h),
                                dilate, w, h, area_margin)
        stats.append(read_queue_stats(s, h, w)[:4])
    agg = tuple(max(st[j] for st in stats) for j in range(4))
    s_cap, m_y, m_x, t_cap = suggest_queue_config(agg)
    return dict(s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap, shade_w=SHADE_W)


def amortized_frames(scene: pp.Scene, eyes, caps: dict, dilate: int,
                     area_margin: int, per_pixel: bool, rebuild_every: int,
                     w: int = W, h: int = H):
    """The amortized moving frames, a generator of (fb, stale): one queue
    from the dilated setup at the first eye of each chunk of
    `rebuild_every` frames, and each frame of the chunk rendered through
    it (rustexp_tpu/app/benchmark.py:362-381). `stale` is a device flag:
    the structure did not cover the frame."""
    for c in range(0, len(eyes), rebuild_every):
        s0 = dilate_setup_planar(pp._queue_setup(scene, eyes[c], w, h),
                                 dilate, w, h, area_margin)
        queue = build_queue(s0, h, w, **caps)
        for e in eyes[c:c + rebuild_every]:
            yield pp.render_frame(
                scene, e, TICK, w=w, h=h, mode=pp.MODE_FILL,
                per_pixel=per_pixel, shader_idx=SHADER, bg_idx=0,
                show_cm=False, backend="queue", raster_queue=queue,
                return_overflow=True)


def bench_scene_moving_amortized(mesh_idx: int = 0, per_pixel: bool = True,
                                 runs: int = 8, fps: float = 60.0,
                                 k: int = 128, rebuild_every: int = 4,
                                 safety: float = 1.5,
                                 device: torch.device | str | None = None
                                 ) -> dict:
    """The moving camera with the queue rebuilt every `rebuild_every`
    frames from a dilated setup (rustexp_tpu/app/benchmark.py:280).

    The margins come from the path itself (amortized_margins), the caps
    from the dilated stats (amortized_caps); k is cut to a multiple of
    rebuild_every. Timed as bench_scene_moving; the stale flag
    accumulates on the card, is read once at the end, and a set flag
    raises (the superset was not certified, so the frames could differ
    from a rebuild every frame).
    """
    device = _card(device)
    m = mesh.get_mesh(mesh_idx)
    cm = cubemap.get_cm_set(ENV)
    scene = pp.make_scene(m, cm, device)
    k -= k % rebuild_every
    eyes = path_eyes(mesh_idx, k, fps)
    dilate, area_margin = amortized_margins(scene, eyes, rebuild_every,
                                            safety)
    caps = amortized_caps(scene, eyes, dilate, area_margin)
    stale = torch.zeros((), dtype=torch.bool, device=device)

    def frames() -> None:
        nonlocal stale
        for _, st_ in amortized_frames(scene, eyes, caps, dilate,
                                       area_margin, per_pixel,
                                       rebuild_every):
            stale = stale | st_

    frames()  # warm-up
    st = _run_stats(lambda: _event_seconds(frames), runs, k)
    if bool(stale):
        raise RuntimeError(
            f"the amortized structure went stale within a chunk (dilate "
            f"{dilate} px, area margin {area_margin}): margins too small")
    return {
        "metric": "raster_moving_amortized_us_per_frame",
        "value": st["best"] * 1e6, "unit": "us", "frames": k,
        "rebuild_every": rebuild_every, "dilate_px": dilate,
        "area_margin": area_margin, "scene": _label(mesh_idx, per_pixel),
        "us_median": st["median"] * 1e6, "spread_pct": st["spread_pct"],
        "n_runs": st["n_runs"],
        "device": torch.cuda.get_device_name(device),
        "queue_order": _order(scene, caps), **caps, **_assets(m, cm),
    }


# ---------------------------------------------------------------------------
# GoL cell updates/s and N-body steps/s (rustexp_tpu/app/benchmark.py:406):
# one call advances k generations or steps; each run times one call.
# ---------------------------------------------------------------------------


def bench_gol(generations_per_dispatch: int = 65536, runs: int = 3,
              n: int = 256, backend: str = "bits",
              device: torch.device | str | None = None) -> dict:
    """Cell updates/s on the n x n torus (reference: 256, gol.rs:8) from a
    random grid (numpy seed 0), one call of k generations per run.

    "bits" is kernel B4 (ops/gol_bits.py, pack and unpack included, as in
    JAX), "pallas" kernel B8; a grid either cannot take goes to "mxu", as
    the JAX bench does. The record names the card and the route.
    """
    device = _card(device)
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.integers(0, 2, (n, n)).astype(np.int32)).to(
        device)
    k = int(generations_per_dispatch)
    if backend == "bits" and n % gol_bits.BITS:
        backend = "mxu"
    if backend == "pallas" and n * n > gol_stencil.MAX_PALLAS_CELLS:
        backend = "mxu"
    out = grid

    def call() -> None:
        nonlocal out
        if backend == "bits":
            out = gol_bits.multi_step_swar(grid, k)
        elif backend == "pallas":
            out = gol_stencil.multi_step_pallas(grid, k)
        else:
            out = gol_stencil.multi_step(grid, k, backend)

    call()  # warm-up: first-use kernel build
    torch.cuda.synchronize(device)
    st = _run_stats(lambda: _event_seconds(call), runs, k)
    rec = {
        "metric": "gol_cell_updates_per_s",
        "value": n * n / st["best"],
        "unit": "cells/s",
        "gens_per_s": 1.0 / st["best"],
        "value_median": n * n / st["median"],
        "spread_pct": st["spread_pct"],
        "n_runs": st["n_runs"],
        "n": n,
        "generations": k,
        "route": backend,
        "live_cells": int(out.sum()),
        "device": torch.cuda.get_device_name(device),
    }
    if n * n <= 1 << 17:
        # as JAX's record flags its launch-bound small grid
        rec["note"] = ("one SM's work at this size (B4 resident); see "
                       "gol_2048 for the form that fills the card")
    return rec


def bench_nbody(n: int = 131072, steps_per_dispatch: int = 64, runs: int = 3,
                backend: str = "pallas", approx_recip: bool = True,
                device: torch.device | str | None = None) -> dict:
    """Steps/s at N particles (north-star config: N = 131,072 stable
    orbits from JAX's PRNGKey(0), core/prng.py), one call of k steps per run.

    "pallas" is the brute force through kernel B5 (``approx_recip`` picks
    its reciprocal), "bh" block Barnes-Hut at theta 0.85, block 256
    (Morton sort through kernel B6 at power-of-two N), "brute" the
    blocked all-pairs torch form. Each run restarts from the same initial
    conditions; the record names the card and the route.
    """
    from ..sims.nbody import stable_orbits

    device = _card(device)
    state0 = stable_orbits(prng.key(0), n, device=device)
    k = int(steps_per_dispatch)
    block = 256
    kk = nbody_bh.theta_to_k(0.85, n // block) if backend == "bh" else 0
    out = state0

    def call() -> None:
        nonlocal out
        px, py, vx, vy, m = state0
        for _ in range(k):
            if backend == "bh":
                px, py, vx, vy, m = nbody_bh.step_bh(px, py, vx, vy, m,
                                                     block, kk)
            elif backend == "pallas":
                px, py, vx, vy = nbody_pallas.step_brute_pallas(
                    px, py, vx, vy, m, 1024, approx_recip)
            else:
                px, py, vx, vy = nbody_forces.step_brute_force(
                    px, py, vx, vy, m, block=1024)
        out = (px, py, vx, vy, m)

    call()  # warm-up: first-use kernel build and allocator growth
    torch.cuda.synchronize(device)
    st = _run_stats(lambda: _event_seconds(call), runs, k)
    return {
        "metric": "nbody_steps_per_s",
        "value": 1.0 / st["best"],
        "unit": "steps/s",
        "n": n,
        "steps": k,
        "backend": backend,
        "route": "bh" if backend == "bh" else "brute",
        "approx_recip": approx_recip if backend == "pallas" else None,
        "k_near": kk or None,
        "value_median": 1.0 / st["median"],
        "spread_pct": st["spread_pct"],
        "n_runs": st["n_runs"],
        "finite": bool(torch.isfinite(torch.stack(out)).all()),
        "device": torch.cuda.get_device_name(device),
    }

"""The 12-scene rasterizer benchmark on the card: per-scene rows and the suite.

Port of rustexp_tpu/app/benchmark.py (SCENES, the scene constants,
QUEUE_MIN_TRIS, _run_stats, bench_scene and run_suite). The scene
matches the reference's rast_benchmark (rasterizer.rs:1781-1884): 512x512,
Fill, shader 5 (CMRefl), envmap 0, tick 0. Frames are timed with CUDA
events around K back-to-back frames; a device without CUDA is refused,
never measured on the CPU instead. The JAX package's TPU-only columns
(its stored TPU times and the "vs-own" ratio) are not carried over, and
the moving-camera rows are ROADMAP A8.
"""

from __future__ import annotations

import torch

from ..assets import cubemap, mesh
from ..raster import camera, pipeline as pp

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

FRAMES_PER_RUN = 32  # back-to-back frames between one pair of CUDA events


def _run_stats(run, runs: int, per: float) -> dict:
    """Call run() `runs` times; run returns the seconds it took. Per-unit
    seconds {best, median, spread_pct, n_runs}, spread =
    (max - min) / median * 100, so the noise floor travels with the number."""
    ts = sorted(run() / per for _ in range(max(1, runs)))
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    spread = (ts[-1] - ts[0]) / med * 100 if med else 0.0
    return {"best": ts[0], "median": med, "spread_pct": spread, "n_runs": n}


def scene_frame(mesh_idx: int, per_pixel: bool, device: torch.device):
    """One bench scene on `device` -> (frame, structure, mesh, envmap).

    The raster structure is built once and reused, as the renderer does
    for a temporally coherent camera: a flat queue for meshes of >=
    QUEUE_MIN_TRIS triangles, else a suggest_binning config for the bins.
    frame() renders one frame and returns its stale/overflow flag, a
    device tensor; each frame pays transform, setup, binning or row
    gather, the raster kernel (B1 or B2), shading and pack. `structure`
    names the backend and its structure (queue order and shade_w, or cap,
    spans and rows_cap).
    """
    m = mesh.get_mesh(mesh_idx)
    cm = cubemap.get_cm_set(ENV)
    scene = pp.make_scene(m, cm, device)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), TICK)
    if m.num_tris >= QUEUE_MIN_TRIS:
        queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
        kw = dict(backend="queue", raster_queue=queue)
        structure = {"backend": "queue", "queue_order": "tri",
                     "shade_w": queue.shade_w}
    else:
        cap, spans, rows_cap = pp.suggest_binning(scene, eye, W, H)
        kw = dict(backend="pallas", raster_cap=cap, raster_spans=spans,
                  raster_rows=rows_cap)
        structure = {"backend": "pallas", "cap": cap, "spans": list(spans),
                     "rows_cap": rows_cap}

    def frame() -> torch.Tensor:
        _, stale = pp.render_frame(
            scene, eye, TICK, w=W, h=H, mode=pp.MODE_FILL,
            per_pixel=per_pixel, shader_idx=SHADER, bg_idx=0, show_cm=False,
            return_overflow=True, **kw)
        return stale

    return frame, structure, m, cm


def bench_scene(mesh_idx: int, per_pixel: bool, runs: int,
                device: torch.device) -> dict:
    """Per-frame seconds for one scene (scene_frame), as a record.

    Each run times FRAMES_PER_RUN back-to-back frames between two CUDA
    events. The record names the card, the backend and its structure, and
    whether the mesh and envmap are the procedural stand-ins (assets
    absent) or the reference's.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"bench_scene times the card; got device {device}")
    frame, structure, m, cm = scene_frame(mesh_idx, per_pixel, device)
    stale_any = torch.zeros((), dtype=torch.bool, device=device)

    def run() -> float:
        nonlocal stale_any
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FRAMES_PER_RUN):
            stale_any = stale_any | frame()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    frame()  # warm-up: first-use kernel build and allocator growth
    torch.cuda.synchronize(device)
    st = _run_stats(run, runs, FRAMES_PER_RUN)
    if bool(stale_any):
        raise RuntimeError("the cached raster structure went stale or "
                           "overflowed at a fixed eye")
    label = next((s[0] for s in SCENES
                  if s[1] == mesh_idx and s[2] == per_pixel),
                 f"mesh{mesh_idx}{'P' if per_pixel else 'V'}")
    return {
        "scene": label, **st, "frames_per_run": FRAMES_PER_RUN,
        "device": torch.cuda.get_device_name(device), **structure,
        "triangles": m.num_tris,
        "mesh": "procedural stand-in" if m.name.endswith("(procedural)")
        else "reference asset",
        "envmap": "procedural stand-in" if cm.name.endswith("(procedural)")
        else "reference asset",
    }


def run_suite(runs: int, device: torch.device) -> dict:
    """All 12 SCENES through bench_scene -> the headline record
    (rustexp_tpu/app/benchmark.py:162).

    Like the JAX package's suite, each scene counts its best run's
    per-frame time; ``value`` is 12 x 512^2 pixels over their sum, and
    ``vs_baseline`` the reference CPU's 27,286 us over that sum.
    ``scene_us`` holds each scene's best and ``rows`` each full record,
    with its median, spread and stand-in flags.
    """
    rows = [bench_scene(mesh_idx, per_pixel, runs, device)
            for _, mesh_idx, per_pixel, _ in SCENES]
    total_s = sum(r["best"] for r in rows)
    return {
        "metric": "raster_suite_Mpix_per_s",
        "value": len(rows) * W * H / total_s / 1e6,
        "unit": "Mpix/s",
        "vs_baseline": REF_TOTAL_US / (total_s * 1e6),
        "scene_us": {r["scene"]: r["best"] * 1e6 for r in rows},
        "device": rows[0]["device"],
        "rows": rows,
    }

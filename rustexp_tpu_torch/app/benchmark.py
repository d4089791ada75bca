"""The 12-scene rasterizer benchmark's per-scene row, on the card.

Port of rustexp_tpu/app/benchmark.py (SCENES, the scene constants,
QUEUE_MIN_TRIS, _run_stats and bench_scene for queue scenes). The scene
matches the reference's rast_benchmark (rasterizer.rs:1781-1884): 512x512,
Fill, shader 5 (CMRefl), envmap 0, tick 0. Frames are timed with CUDA
events around K back-to-back frames; a device without CUDA is refused,
never measured on the CPU instead. run_suite and the moving-camera rows
are ROADMAP A8/A11.
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

# Meshes below this triangle count take the [nT, cap] bins path (ROADMAP
# A9/B2); at or above it, the flat queue (kernel B1).
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


def bench_scene(mesh_idx: int, per_pixel: bool, runs: int,
                device: torch.device) -> dict:
    """Per-frame seconds for one scene, as a record.

    The queue is built once and reused, as the renderer does for a
    temporally coherent camera; each frame still pays transform, setup,
    row gather, kernel B1, shading and pack. Each run times FRAMES_PER_RUN
    back-to-back frames between two CUDA events. The record names the
    card, the queue order and shade_w, and whether the mesh and envmap
    are the procedural stand-ins (assets absent) or the reference's.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"bench_scene times the card; got device {device}")
    m = mesh.get_mesh(mesh_idx)
    if m.num_tris < QUEUE_MIN_TRIS:
        raise NotImplementedError(
            f"mesh {mesh.mesh_name(mesh_idx)} ({m.num_tris} triangles) takes "
            "the bins path, ROADMAP A9/B2")
    cm = cubemap.get_cm_set(ENV)
    scene = pp.make_scene(m, cm, device)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), TICK)
    queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
    stale_any = torch.zeros((), dtype=torch.bool, device=device)

    def frame():
        nonlocal stale_any
        _, stale = pp.render_frame(
            scene, eye, TICK, w=W, h=H, mode=pp.MODE_FILL,
            per_pixel=per_pixel, shader_idx=SHADER, bg_idx=0, show_cm=False,
            backend="queue", raster_queue=queue, return_overflow=True)
        stale_any = stale_any | stale

    def run() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FRAMES_PER_RUN):
            frame()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    frame()  # warm-up: first-use kernel build and allocator growth
    torch.cuda.synchronize(device)
    st = _run_stats(run, runs, FRAMES_PER_RUN)
    if bool(stale_any):
        raise RuntimeError("the cached queue went stale at a fixed eye")
    label = next((s[0] for s in SCENES
                  if s[1] == mesh_idx and s[2] == per_pixel),
                 f"mesh{mesh_idx}{'P' if per_pixel else 'V'}")
    return {
        "scene": label, **st, "frames_per_run": FRAMES_PER_RUN,
        "device": torch.cuda.get_device_name(device),
        "queue_order": "tri", "shade_w": queue.shade_w,
        "triangles": m.num_tris,
        "mesh": "procedural stand-in" if m.name.endswith("(procedural)")
        else "reference asset",
        "envmap": "procedural stand-in" if cm.name.endswith("(procedural)")
        else "reference asset",
    }

"""The benchmarks on the card: the 12-scene rasterizer suite, GoL and N-body.

Port of rustexp_tpu/app/benchmark.py (SCENES, the scene constants,
QUEUE_MIN_TRIS, _run_stats, bench_scene, run_suite, bench_gol and
bench_nbody). The scene matches the reference's rast_benchmark
(rasterizer.rs:1781-1884): 512x512, Fill, shader 5 (CMRefl), envmap 0,
tick 0. Work is timed with CUDA events around a batch (K back-to-back
frames, or one call of k generations or steps); a device without CUDA is
refused, never measured on the CPU instead. The JAX package's TPU-only
columns (its stored TPU times and the "vs-own" ratio) are not carried
over, and the moving-camera rows are ROADMAP A8.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assets import cubemap, mesh
from ..ops import gol_bits, gol_stencil, nbody_bh, nbody_forces, nbody_pallas
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
    device = _card(device)
    frame, structure, m, cm = scene_frame(mesh_idx, per_pixel, device)
    stale_any = torch.zeros((), dtype=torch.bool, device=device)

    def frames() -> None:
        nonlocal stale_any
        for _ in range(FRAMES_PER_RUN):
            stale_any = stale_any | frame()

    def run() -> float:
        return _event_seconds(frames)

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
    return {
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


def bench_nbody(n: int = 131072, steps_per_dispatch: int = 64, runs: int = 3,
                backend: str = "pallas", approx_recip: bool = True,
                device: torch.device | str | None = None) -> dict:
    """Steps/s at N particles (north-star config: N = 131,072 stable
    orbits from torch.Generator seed 0), one call of k steps per run.

    "pallas" is the brute force through kernel B5 (``approx_recip`` picks
    its reciprocal), "bh" block Barnes-Hut at theta 0.85, block 256
    (Morton sort through kernel B6 at power-of-two N), "brute" the
    blocked all-pairs torch form. Each run restarts from the same initial
    conditions; the record names the card and the route.
    """
    from ..sims.nbody import stable_orbits

    device = _card(device)
    state0 = stable_orbits(torch.Generator().manual_seed(0), n,
                           device=device)
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

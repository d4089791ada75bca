"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives rustexp_tpu_torch, the port, never the JAX package:

  1. requires a CUDA device and prints nvidia-smi's name and power limit;
  2. builds the port's CUDA kernels from rustexp_tpu_torch/csrc/;
  3. holds kernel B1 (the flat-queue raster) against its plain PyTorch
     version on the card, on the procedural Killeroo and TorusKnot at
     512x512, per-vertex (V) and per-pixel (P): z, slot and every
     attribute plane must be bit-equal under the coverage mask;
  4. runs the main path — RasterizerExperiment.render for KillerooV and
     KillerooP, a few ticks each, and one bench_scene row — with B1's
     launch counter reset just before and read just after, and checks
     that B1 ran, that the frames are not background and that each
     matches the port's CPU frame within 0.3% of pixels (the repo's
     golden bound, tests/test_golden.py);
  5. prints CUDA-event times: B1 vs its plain version, and per frame.

Its last two lines are a JSON object of the kernels, then
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
when there is no CUDA device, a build or launch fails, or a check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

W = H = 512
SMOKE_SCENES = (("KillerooV", 0, False), ("KillerooP", 0, True),
                ("TorusKnotV", 6, False), ("TorusKnotP", 6, True))
TICKS = (0.0, 0.05, 0.1)
GOLDEN_FRAC = 0.003  # tests/test_golden.py: <= 0.3% differing pixels


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back calls, by CUDA
    events, after two warm-up calls."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(dev, scenes, meshes, cubemap, pp, rq, camera):
    """Phase 3: B1 against its plain version at the main path's shapes.
    Returns {label: (max_abs_err, bad_count, covered, ms, plain_ms)}."""
    out = {}
    for label, mesh_idx, per_pixel in scenes:
        scene = pp.make_scene(meshes.get_mesh(mesh_idx),
                              cubemap.get_cm_set(0), dev)
        eye = camera.camera_eye(meshes.mesh_camera(mesh_idx), 0.0)
        queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
        colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0,
                                                         W, H, 5)
        setup, extra, n2, n3 = pp.queue_attr_channels(
            scene, colors, eye, W, H, per_pixel=per_pixel)
        rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
        args = (queue.scal, rows_i, rows_f, n2, n3, H, W)
        zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
        zp, sp, lp = rq.raster_attrs_queue_plain(*args)
        torch.cuda.synchronize(dev)
        mask = sp >= 0
        bad = int((sk != sp).sum())  # slot, hence mask, everywhere
        bad += int((zk.view(torch.int32) != zp.view(torch.int32))[mask].sum())
        bad += int((lk.view(torch.int32) != lp.view(torch.int32))[:, mask].sum())
        err = max(float((zk - zp)[mask].abs().max()),
                  float((lk - lp)[:, mask].abs().max())) if mask.any() else 0.0
        ms = cuda_ms(lambda: rq.raster_attrs_queue_cuda(*args), 50)
        plain_ms = cuda_ms(lambda: rq.raster_attrs_queue_plain(*args), 5)
        out[label] = (err, bad, int(mask.sum()), ms, plain_ms)
        print(f"B1 {label}: {int(mask.sum())} covered px, {int(queue.scal[:, 3].sum())} "
              f"pairs, n2={n2} n3={n3}: {bad} mismatching words, "
              f"max_abs_err {err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    from rustexp_tpu_torch.app.benchmark import bench_scene
    from rustexp_tpu_torch.assets import cubemap, mesh as meshes
    from rustexp_tpu_torch.ops import raster_queue as rq
    from rustexp_tpu_torch.raster import camera, pipeline as pp
    from rustexp_tpu_torch.runtime import device, load_kernel_lib
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

    if "jax" in sys.modules:
        return fail("the port pulled jax in")
    dev = device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = load_kernel_lib("raster_queue")
    print(f"built {lib.path.name} in {lib.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)", flush=True)

    # Phase 3: kernel vs plain, on the card.
    cmp = kernel_vs_plain(dev, SMOKE_SCENES, meshes, cubemap, pp, rq, camera)
    for label, (err, bad, covered, _, _) in cmp.items():
        if bad or covered == 0:
            return fail(f"B1 {label}: {bad} mismatching words, "
                        f"{covered} covered pixels")

    # Phase 4: the main path, counted.
    rq.raster_attrs_queue_cuda.launches = 0
    exp = RasterizerExperiment(dev)
    frames = {}
    for per_pixel in (False, True):
        st = exp.init(per_pixel=per_pixel)
        for tick in TICKS:
            frames[(per_pixel, tick)] = exp.render(st, W, H, tick)
        print(f"Experiment {'KillerooP' if per_pixel else 'KillerooV'}: "
              f"{exp.status(st)}", flush=True)
    row = bench_scene(0, True, runs=5, device=dev)
    launches = rq.raster_attrs_queue_cuda.launches
    print(f"B1 launches during the main path: {launches}", flush=True)
    print("bench_scene " + json.dumps(row), flush=True)
    if launches == 0:
        return fail("the main path never launched kernel B1")

    cpu = RasterizerExperiment("cpu")
    empty = pp.overlay_cross(pp.background(0, W, H, "cpu"),
                             pp.make_scene(meshes.get_mesh(0),
                                           cubemap.get_cm_set(0), "cpu").cross)
    for (per_pixel, tick), fb in frames.items():
        name = f"{'KillerooP' if per_pixel else 'KillerooV'} tick {tick}"
        if fb.shape != (H, W) or fb.dtype != torch.uint32 or fb.device != dev:
            return fail(f"{name}: frame {fb.dtype} {tuple(fb.shape)} "
                        f"on {fb.device}")
        ref = cpu.render(cpu.init(per_pixel=per_pixel), W, H, tick)
        gpu = fb.cpu().view(torch.int32)
        drawn = int((gpu != empty).sum())
        diff = int((gpu != ref.view(torch.int32)).sum())
        print(f"{name}: {drawn} px drawn over the background, {diff} px "
              f"differ from the port's CPU frame", flush=True)
        if drawn < W * H // 100:
            return fail(f"{name}: frame is (nearly) all background")
        if diff > GOLDEN_FRAC * W * H:
            return fail(f"{name}: {diff} px differ from the CPU frame")

    # Phase 5: times, each beside the card's name and power limit.
    for label, (_, _, _, ms, plain_ms) in cmp.items():
        print(f"time B1 {label} 512x512: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms [{card}]")
    print(f"time frame KillerooP 512x512 (bench_scene, CUDA events): "
          f"median {row['median'] * 1e3:.4f} ms, best {row['best'] * 1e3:.4f} "
          f"ms, spread {row['spread_pct']:.1f}% [{card}]")

    err, _, _, ms, plain_ms = cmp["KillerooP"]
    print(json.dumps({"kernels": [{
        "name": "queue_raster (B1)", "route": "cuda",
        "source": "rustexp_tpu_torch/csrc/raster_queue.cu",
        "replaces": "rustexp_tpu/ops/raster_queue.py:690",
        "launches": launches,
        "max_abs_err": max(c[0] for c in cmp.values()),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

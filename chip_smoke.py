"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives rustexp_tpu_torch, the port, never the JAX package:

  1. requires a CUDA device and prints nvidia-smi's name and power limit;
  2. builds the port's CUDA kernels from rustexp_tpu_torch/csrc/, one nvcc
     per source, all started together;
  3. holds each kernel against its plain PyTorch version on the card, at
     the main path's 512x512 shapes, bit for bit (0 mismatching words):
     B1 (the flat-queue raster) on the procedural Killeroo and TorusKnot,
     per-vertex (V) and per-pixel (P), under the coverage mask; B2 (the
     binned raster) on CubeV and CubeP at suggest_binning's cap and spans
     (the suite's shapes) and on TorusKnotP and KillerooP at
     render_frame(backend="pallas")'s default bins, over the whole frame;
  4. runs each main path with the launch counters set to 0 just before it
     and read just after, and fails if its kernel never ran: the queue path
     (RasterizerExperiment.render, KillerooV and KillerooP, a few ticks),
     the bins path (the same on Cube, mesh 9) and the 12-scene run_suite;
     each Experiment frame must be more than background and match the
     port's CPU frame within 0.3% of pixels (the repo's golden bound,
     tests/test_golden.py);
  5. prints times, each with the card's name and power limit: each
     kernel's device time (torch.profiler), its wrapper call's and its
     plain version's (CUDA events), the bench frames and the suite, and
     per bench scene the device-busy time, device activities and raster
     kernel time per frame (torch.profiler) with the device's idle share
     of the suite's unprofiled frame time.

Its last lines are nvidia-smi's name and power limit, a JSON object of the
kernels (launches on the main paths, error, times and each one's bound),
then {"ok": true, "device": {...}}. It exits non-zero, printing no result,
when there is no CUDA device, a build or launch fails, or a check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

W = H = 512
B1_SCENES = (("KillerooV", 0, False), ("KillerooP", 0, True),
             ("TorusKnotV", 6, False), ("TorusKnotP", 6, True))
# (label, mesh, per_pixel, binning): "suite" = suggest_binning's cap and
# spans, as bench_scene renders the Cube; "default" = render_frame's
# backend="pallas" without them (capacity T, dense coverage binning)
B2_SCENES = (("CubeV", 9, False, "suite"), ("CubeP", 9, True, "suite"),
             ("TorusKnotP", 6, True, "default"),
             ("KillerooP", 0, True, "default"))
EXPERIMENT_MESHES = (("Killeroo", 0), ("Cube", 9))
TICKS = (0.0, 0.05, 0.1)
SUITE_RUNS = 3
PROFILE_FRAMES = 20  # frames per bench scene under torch.profiler
GOLDEN_FRAC = 0.003  # tests/test_golden.py: <= 0.3% differing pixels

# The least time the card could take (H100 SXM peak rates): bytes
# over 3.35 TB/s, operations over the 67 TFLOP/s FP32 rate (the int32 edge
# math counted at that rate too; it is not faster). Per (triangle, pixel
# of its box in the tile): e0 and e1 (2 mul + 2 add each), e2 (2 sub), the
# sign-OR test (3), the box test (7), b0 and b2 (sub, convert, mul each),
# z (2 mul + 2 add), the depth compare and select (2). Per winning pixel:
# b1 (3), then 4 per two-MAD plane and 5 per three-weight plane.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_TEST = 32
OPS_B1, OPS_2MAD, OPS_3W = 3, 4, 5


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


def device_events(fn, reps: int) -> list:
    """The card's activities (kernels, copies, sets) that torch.profiler
    saw over `reps` fn() calls, after two warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of the CUDA kernels whose name contains
    `kernel`, per fn() call. Unlike CUDA events around back-to-back calls,
    this does not count the host's launch time when a kernel is shorter
    than it."""
    spans = [e.time_range.end - e.time_range.start
             for e in device_events(fn, reps) if kernel in e.name]
    if len(spans) != reps:
        raise RuntimeError(f"profiler saw {len(spans)} launches of {kernel} "
                           f"in {reps} calls")
    return sum(spans) / 1e3 / reps


def busy_ms(events) -> float:
    """Milliseconds of the union of the events' device intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def frame_breakdowns(bench, suite) -> list[dict]:
    """Per bench scene, where a frame's time goes on the card: device-busy
    ms, device activities and raster-kernel ms per frame, by the profiler
    over PROFILE_FRAMES frames, and the idle share against the scene's
    median frame time in the unprofiled run_suite (the profiler's own host
    overhead stretches a profiled frame's wall time)."""
    wall = {r["scene"]: r["median"] * 1e3 for r in suite["rows"]}
    out = []
    for label, mesh_idx, per_pixel, _ in bench.SCENES:
        frame, structure, _, _ = bench.scene_frame(mesh_idx, per_pixel,
                                                   torch.device("cuda"))
        events = device_events(frame, PROFILE_FRAMES)
        busy = busy_ms(events) / PROFILE_FRAMES
        raster = sum(e.time_range.end - e.time_range.start for e in events
                     if "raster_kernel" in e.name) / 1e3 / PROFILE_FRAMES
        out.append(dict(scene=label, backend=structure["backend"],
                        wall_ms=wall[label], busy_ms=busy,
                        idle=1.0 - busy / wall[label],
                        activities=len(events) / PROFILE_FRAMES,
                        raster_ms=raster))
    return out


def box_px(rec_i, x0, y0, th: int, tw: int) -> torch.Tensor:
    """int64 pixels of each record's AABB (int channels 7..10) inside its
    th x tw tile at (x0, y0); rec_i's channel dim is the last."""
    wx = (torch.minimum(rec_i[..., 9], x0 + tw)
          - torch.maximum(rec_i[..., 7], x0)).clamp(min=0)
    wy = (torch.minimum(rec_i[..., 10], y0 + th)
          - torch.maximum(rec_i[..., 8], y0)).clamp(min=0)
    return wx.long() * wy.long()


def bound(bytes_moved: int, tests: int, won: int, n2: int, n3: int):
    """(bound_ms, bound_by) of one raster call."""
    ops = tests * OPS_PER_TEST + won * (OPS_B1 + OPS_2MAD * n2 + OPS_3W * n3)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bit_mismatches(zk, sk, lk, zp, sp, lp, mask) -> int:
    """Words of (z, slot, planes) that differ, z and planes under `mask`."""
    bad = int((sk != sp).sum())
    bad += int((zk.view(torch.int32) != zp.view(torch.int32))[mask].sum())
    bad += int((lk.view(torch.int32) != lp.view(torch.int32))[:, mask].sum())
    return bad


def max_abs_err(zk, lk, zp, lp, mask) -> float:
    if not mask.any():
        return 0.0
    return max(float((zk - zp)[mask].abs().max()),
               float((lk - lp)[:, mask].abs().max()))


def b1_vs_plain(dev, pp, rq, meshes, cubemap, camera):
    """B1 against its plain version at the main path's shapes.
    Returns {label: record}."""
    out = {}
    for label, mesh_idx, per_pixel in B1_SCENES:
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
        bad = bit_mismatches(zk, sk, lk, zp, sp, lp, mask)
        err = max_abs_err(zk, lk, zp, lp, mask)

        scal = queue.scal
        live = (torch.arange(rq.CHUNK, device=dev)[None, :]
                < scal[:, 3:4])                                  # [S, CHUNK]
        pairs = int(live.sum())
        rec = rows_i.permute(0, 2, 1)                        # [S, CHUNK, 12]
        tests = int((box_px(rec, (scal[:, 1] * rq.TILE_W)[:, None],
                            (scal[:, 4] * rq.TILE_H)[:, None], rq.TILE_H,
                            rq.TILE_W) * live).sum())
        bytes_moved = (scal.numel() * 4 + pairs * (rows_i.shape[1]
                                                   + rows_f.shape[1]) * 4
                       + zk.numel() * 4 + sk.numel() * 4 + lk.numel() * 4)
        bms, by = bound(bytes_moved, tests, int(mask.sum()), n2, n3)
        ms = device_ms(lambda: rq.raster_attrs_queue_cuda(*args), 50,
                       "queue_raster_kernel")
        call_ms = cuda_ms(lambda: rq.raster_attrs_queue_cuda(*args), 50)
        plain_ms = cuda_ms(lambda: rq.raster_attrs_queue_plain(*args), 5)
        out[label] = dict(err=err, bad=bad, covered=int(mask.sum()), ms=ms,
                          call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, work=f"{pairs} pairs")
        print(f"B1 {label}: {int(mask.sum())} covered px, {pairs} pairs, "
              f"n2={n2} n3={n3}: {bad} mismatching words, max_abs_err "
              f"{err}", flush=True)
    return out


def b2_vs_plain(dev, pp, rb, setup_triangles, meshes, cubemap, camera):
    """B2 against its plain version at the main path's shapes.
    Returns {label: record}."""
    out = {}
    for label, mesh_idx, per_pixel, binning in B2_SCENES:
        scene = pp.make_scene(meshes.get_mesh(mesh_idx),
                              cubemap.get_cm_set(0), dev)
        eye = camera.camera_eye(meshes.mesh_camera(mesh_idx), 0.0)
        cap = spans = None
        if binning == "suite":
            cap, spans, _ = pp.suggest_binning(scene, eye, W, H)
        vp, world, n_world = pp.transform_vertices(scene, eye, W, H)
        colors = scene.colors if per_pixel else pp.vertex_colors(
            scene, eye, 0.0, W, H, 5)
        extra, n2, n3 = pp.bins_attr_channels(scene, vp, world, n_world,
                                              colors, per_pixel=per_pixel)
        bins = rb.make_bins(setup_triangles(vp, scene.tris, W, H), extra,
                            n2, n3, H, W, cap=cap, spans=spans)
        if bool(bins.overflow):
            raise RuntimeError(f"B2 {label}: the bins overflowed")
        args = (bins.counts, bins.setup_i, bins.setup_f, n2, n3, H, W)
        zk, sk, lk = rb.raster_attrs_bins_cuda(*args)
        zp, sp, lp = rb.raster_attrs_bins_plain(*args)
        torch.cuda.synchronize(dev)
        everywhere = torch.ones_like(sp, dtype=torch.bool)
        bad = bit_mismatches(zk, sk, lk, zp, sp, lp, everywhere)
        mask = sp >= 0
        err = max_abs_err(zk, lk, zp, lp, mask)

        n_tiles, cap_, _ = bins.setup_i.shape
        live = (torch.arange(cap_, device=dev)[None, :]
                < bins.counts[:, None])                          # [nT, cap]
        slots = int(live.sum())
        tiles = torch.arange(n_tiles, device=dev)
        ntx = W // rb.TILE_W
        tests = int((box_px(bins.setup_i, ((tiles % ntx) * rb.TILE_W)[:, None],
                            ((tiles // ntx) * rb.TILE_H)[:, None], rb.TILE_H,
                            rb.TILE_W) * live).sum())
        bytes_moved = (bins.counts.numel() * 4
                       + slots * (bins.setup_i.shape[2]
                                  + bins.setup_f.shape[2]) * 4
                       + zk.numel() * 4 + sk.numel() * 4 + lk.numel() * 4)
        bms, by = bound(bytes_moved, tests, int(mask.sum()), n2, n3)
        ms = device_ms(lambda: rb.raster_attrs_bins_cuda(*args), 50,
                       "bins_raster_kernel")
        call_ms = cuda_ms(lambda: rb.raster_attrs_bins_cuda(*args), 50)
        plain_ms = cuda_ms(lambda: rb.raster_attrs_bins_plain(*args), 5)
        out[label] = dict(err=err, bad=bad, covered=int(mask.sum()), ms=ms,
                          call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, work=f"{slots} slots, cap {cap_}")
        print(f"B2 {label}: {int(mask.sum())} covered px, {slots} bin slots "
              f"in {n_tiles} tiles (cap {cap_}, largest bin "
              f"{int(bins.counts.max())}), n2={n2} n3={n3}: {bad} "
              f"mismatching words, max_abs_err {err}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    from rustexp_tpu_torch.app import benchmark as bench
    from rustexp_tpu_torch.assets import cubemap, mesh as meshes
    from rustexp_tpu_torch.ops import raster_bins as rb, raster_queue as rq
    from rustexp_tpu_torch.ops.raster_setup import setup_triangles
    from rustexp_tpu_torch.raster import camera, pipeline as pp
    from rustexp_tpu_torch.runtime import device, load_kernel_lib
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

    pulled = sorted(m for m in sys.modules
                    if m == "jax" or m.split(".")[0] in ("jax", "rustexp_tpu"))
    if pulled:
        return fail(f"the port pulled in {pulled[:5]}")
    dev = device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    # Phase 2: build every kernel, one nvcc per source, concurrently.
    t0 = time.perf_counter()
    names = ("raster_queue", "raster_bins")
    with ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(load_kernel_lib, names))
    for lib in libs:
        print(f"built {lib.path.name} in {lib.build_seconds:.2f} s [{card}]",
              flush=True)
    print(f"all kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"[{card}]", flush=True)

    # Phase 3: each kernel against its plain version, on the card.
    cmp1 = b1_vs_plain(dev, pp, rq, meshes, cubemap, camera)
    cmp2 = b2_vs_plain(dev, pp, rb, setup_triangles, meshes, cubemap, camera)
    for kernel, cmp in (("B1", cmp1), ("B2", cmp2)):
        for label, r in cmp.items():
            if r["bad"] or r["covered"] == 0:
                return fail(f"{kernel} {label}: {r['bad']} mismatching "
                            f"words, {r['covered']} covered pixels")

    # Phase 4: the main paths, each counted on its own.
    counters = {"B1": rq.raster_attrs_queue_cuda,
                "B2": rb.raster_attrs_bins_cuda}
    path_kernels = {"Killeroo": ("B1",), "Cube": ("B2",),
                    "run_suite": ("B1", "B2")}
    launches = {k: 0 for k in counters}
    exp = RasterizerExperiment(dev)
    frames = {}
    for name, mesh_idx in EXPERIMENT_MESHES:
        for c in counters.values():
            c.launches = 0
        for per_pixel in (False, True):
            st = exp.init(mesh_idx=mesh_idx, per_pixel=per_pixel)
            for tick in TICKS:
                frames[(name, mesh_idx, per_pixel, tick)] = exp.render(
                    st, W, H, tick)
            print(f"Experiment {name}{'P' if per_pixel else 'V'}: "
                  f"{exp.status(st)} [{card}]", flush=True)
        got = {k: c.launches for k, c in counters.items()}
        print(f"launches during the {name} Experiment path: {got}",
              flush=True)
        for k in path_kernels[name]:
            if got[k] == 0:
                return fail(f"the {name} path never launched kernel {k}")
        for k in counters:
            launches[k] += got[k]

    for c in counters.values():
        c.launches = 0
    suite = bench.run_suite(SUITE_RUNS, dev)
    got = {k: c.launches for k, c in counters.items()}
    print(f"launches during run_suite: {got}", flush=True)
    for k in path_kernels["run_suite"]:
        if got[k] == 0:
            return fail(f"run_suite never launched kernel {k}")
    for k in counters:
        launches[k] += got[k]
    if len(suite["scene_us"]) != 12:
        return fail(f"run_suite timed {len(suite['scene_us'])} scenes")

    cpu = RasterizerExperiment("cpu")
    for (name, mesh_idx, per_pixel, tick), fb in frames.items():
        label = f"{name}{'P' if per_pixel else 'V'} tick {tick}"
        if fb.shape != (H, W) or fb.dtype != torch.uint32 or fb.device != dev:
            return fail(f"{label}: frame {fb.dtype} {tuple(fb.shape)} "
                        f"on {fb.device}")
        empty = pp.overlay_cross(
            pp.background(0, W, H, "cpu"),
            pp.make_scene(meshes.get_mesh(mesh_idx), cubemap.get_cm_set(0),
                          "cpu").cross)
        ref = cpu.render(cpu.init(mesh_idx=mesh_idx, per_pixel=per_pixel),
                         W, H, tick)
        gpu = fb.cpu().view(torch.int32)
        drawn = int((gpu != empty).sum())
        diff = int((gpu != ref.view(torch.int32)).sum())
        print(f"{label}: {drawn} px drawn over the background, {diff} px "
              f"differ from the port's CPU frame", flush=True)
        if drawn < W * H // 100:
            return fail(f"{label}: frame is (nearly) all background")
        if diff > GOLDEN_FRAC * W * H:
            return fail(f"{label}: {diff} px differ from the CPU frame")

    # Phase 5: times, each beside the card's name and power limit.
    for kernel, cmp in (("B1", cmp1), ("B2", cmp2)):
        for label, r in cmp.items():
            print(f"time {kernel} {label} 512x512 ({r['work']}): kernel "
                  f"{r['ms']:.4f} ms (device, profiler), wrapper call "
                  f"{r['call_ms']:.4f} ms and plain version "
                  f"{r['plain_ms']:.4f} ms (CUDA events), bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}) [{card}]")
    for r in suite["rows"]:
        print(f"time frame {r['scene']} 512x512 (bench_scene, {r['backend']}, "
              f"CUDA events, {r['n_runs']} runs x {r['frames_per_run']} "
              f"frames, mesh {r['mesh']}): best {r['best'] * 1e3:.4f} ms, "
              f"median {r['median'] * 1e3:.4f} ms, spread "
              f"{r['spread_pct']:.1f}% [{card}]")
    for r in frame_breakdowns(bench, suite):
        print(f"profile frame {r['scene']} 512x512 ({r['backend']}, "
              f"{PROFILE_FRAMES} frames): device busy {r['busy_ms']:.4f} "
              f"ms/frame (profiler, union of the card's activities), "
              f"{r['activities']:.1f} device activities/frame, raster "
              f"kernel {r['raster_ms']:.4f} ms/frame; idle share "
              f"{r['idle'] * 100:.1f}% of the run_suite median "
              f"{r['wall_ms']:.4f} ms/frame [{card}]")
    head = {k: suite[k] for k in ("metric", "value", "unit", "vs_baseline")}
    print(f"run_suite (procedural stand-ins for the meshes and the envmap) "
          f"{json.dumps(head)} [{card}]")
    print(f"run_suite per-scene best us (procedural stand-ins) "
          f"{json.dumps(suite['scene_us'])} [{card}]")

    def entry(name, source, replaces, kernel, cmp, label):
        r = cmp[label]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kernel],
                "max_abs_err": max(c["err"] for c in cmp.values()),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    print(card)
    print(json.dumps({"kernels": [
        entry("queue_raster (B1)", "rustexp_tpu_torch/csrc/raster_queue.cu",
              "rustexp_tpu/ops/raster_queue.py:690", "B1", cmp1, "KillerooP"),
        entry("bins_raster (B2)", "rustexp_tpu_torch/csrc/raster_bins.cu",
              "rustexp_tpu/ops/raster_pallas.py:338", "B2", cmp2, "CubeP"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives rustexp_tpu_torch, the port, never the JAX package:

  1. requires a CUDA device and prints nvidia-smi's name and power limit;
  2. builds the port's seven CUDA libraries (nine kernels) from
     rustexp_tpu_torch/csrc/, one nvcc per source, all started together;
  3. holds each kernel against its plain PyTorch version on the card, at
     the main paths' shapes: B1 (the flat-queue raster) on the procedural
     Killeroo and TorusKnot, per-vertex (V) and per-pixel (P), and
     KillerooP with ray_world=False (its (4, 6) form), under the coverage
     mask, its grid launches a call counted and its time taken over all
     the card's activity of a call, and on the stress queue
     (stress_queue below) in all three forms, slot on every word and the
     clear elsewhere; B2 (the binned raster) on CubeV and CubeP at
     suggest_binning's cap and spans (the suite's shapes) and on
     TorusKnotP and KillerooP at render_frame(backend="pallas")'s
     default bins, and B3 (its G-buffer form) on Killeroo and Cube at
     raster_gbuffer_pallas's default bins, on four 128-row bands of
     Killeroo, 512x512, and on the stress bins (stress_bins below), bit
     for bit (0 mismatching words); B7 (B1's depth race alone, the same
     kernel template with no planes) on KillerooP, KillerooV and
     TorusKnotP, timed by all the card's activity of a call, and on the
     stress queue, z and slot on every word; B1 in all three forms on the
     moving camera's plane queues (KillerooP, TorusKnotP) and direct
     queue (CubeP) at a path eye, timed on the plane and on the tri queue
     of one frame in turns, and B7 on KillerooP's plane queue;
     B4 (SWAR GoL) at packed [8, 256] in both its forms (resident and
     tiled), [64, 2048] tiled and [8, 1024] resident, its input unchanged
     and its launches as planned, and B8 (the f32 GoL stencil) at 256^2 x
     8 generations (the GoL Experiment's call), 256^2 and 512^2 x 20, bit
     for bit, its plan printed and its launches as planned, with the
     registers and spills of every kernel but B6's from ptxas;
     B6 (the radix sort) with five payloads, bit for bit and its inputs
     unchanged, on the N-body's Morton codes at n = 131,072, full-range
     signed keys and an explicit negative idx at 4,096, constant keys at
     256 and random keys at 2^20, timed with the
     library call (stable torch.sort and gathers) by device time in the
     same run; B5 (all-pairs forces) at N = 16,384, 131,072 and 16,385
     with both reciprocals, within B5_RTOL, its launches as planned; S
     (the shade and pack) on the call a bench frame makes of it on the
     sphere (KillerooP: the queue's ray-world rows list) and on CubeP (the
     bins' whole frame of 10 planes), with cube maps dim enough that no
     channel reaches white, 0 differing words against its plain version
     on the card and on the CPU, one grid a call, timed by all the card's
     activity of a call and by its grid alone;
  4. runs each main path with the launch counters set to 0 just before it
     and read just after, and fails if its kernel never ran, or if the
     shade kernel S did not launch once for each raster render (B1, B2
     or B7; none on the G-buffer paths): the queue path
     (RasterizerExperiment.render, KillerooV and KillerooP, a few ticks),
     the bins path (the same on Cube, mesh 9), and run_suite at bench.py's
     runs over its SCENES cut to KillerooP (B1) and CubeP (B2), after short
     batches of the same frames (sampling below: JAX's 1,024-frame warm-up
     and 2 runs of 1,024 frames, each frame with its checksum, against 20
     runs of 32 frames after one; each counted alone, exactly the kernel
     once a frame; the checksums equal the CPU frames');
     the G-buffer band path (render_frame_sharded(group=None,
     backend="pallas") and four bands one after another -> B3), the
     deferred queue frame (raster_and_shade_queue(defer=True), P and V ->
     B7), and render_frame(backend="xla") and the Experiment at a 500x500
     window, which must launch no kernel; the moving camera,
     bench_scene_moving on KillerooP (plane), TorusKnotP (plane) and
     CubeP (direct) and bench_scene_moving_amortized on KillerooP, each
     launching B1 once a frame rendered and nothing else, its card frames
     held against the CPU's at 4 path eyes and the plane queue's frame
     against the tri queue's (0 px), one frame a scene profiled with its
     synchronizing calls counted; all 32 shader x mode frames of Killeroo
     and the 16 shader functions against the CPU; the GoL Experiment at
     256^2
     (auto -> B4, pallas -> B8); the N-body Experiment at N = 131,072
     (theta 0.85 -> block BH, its Morton sort B6; theta 0 -> brute force,
     B5) and at N = 10,000 (BH, argsort); bench_gol (256^2, 2048^2) and
     bench_nbody (brute and BH at 131,072); the seeded states
     (seeded_states below): jax.random's known answers (KAT_*) drawn on
     the card, the GoL R grid at 2048^2, stable orbits at 131,072 and the
     W key's disk of 10,000 drawn on the card equal to the CPU's word for
     word, their draws timed, B4, B5 and B6 on them against their plain
     versions, and the GoL Experiment with backend "bits_banded" (-> B4,
     counted) from the R grid. Each raster frame must be more
     than background and match the port's CPU frame within 0.3% of pixels
     (the repo's golden bound, tests/test_golden.py); the xla, pallas and
     B3 band frames must equal each other and the deferred frames the
     planes frames at 0 px; GoL frames from the card must equal the CPU's bit for
     bit, and N-body frames after a few steps from the same initial
     conditions match within 1% of pixels (the N-body golden's bound);
  5. prints times, each with the card's name and power limit: each
     kernel's device time (torch.profiler), its wrapper call's and its
     plain version's (CUDA events), both samplings' best, median and
     spread, the GoL and N-body bench records, and, after the bench of
     item 8, its 12 scenes' frame times, both samplings here over the
     bench's in its fresh process, and per bench scene the device-busy
     time, device activities and raster kernel time per frame
     (torch.profiler) with the device's idle share of the median frame
     time of 5 unprofiled runs of 20 frames just before the profile, the
     same per G-buffer and deferred path against its CUDA-event frame
     time, and per GoL and N-body bench record per generation or step,
     and each phase's seconds;
  6. drives the app shell as a user calls it (app_shell below): the CLI
     (rustexp_tpu_torch.app.cli.main) on the rasterizer at 512^2 with PNGs
     and a GIF, its point and line modes (keys M, MM) on Killeroo and
     TorusKnot, the Cube (W keys: the bins, B2), per-pixel (P), a
     64-frame turntable (--animate) of KillerooP, GoL at 256^2 over a
     --save-state and a --load-state (and an R key after the load), N-body
     at its defaults and resumed at N = 16,384, and sine; then the viewer
     (app.viewer.run_viewer) headless with each experiment as its start.
     Each run's launches are counted on their own (B1 once a frame
     rendered, stale rebuilds included, each counted by its core.trace line
     in a file sink; B2 on the Cube; B4 once a GoL step;
     B6 12 times a BH step at 16,384; none for points, lines and sine); the
     PNGs must equal the card's frames, the point, line and sine frames the
     CPU's at 0 px, the resumed GoL the uninterrupted run bit for bit; it
     prints each run's wall ms per frame and the viewer's report lines;
  7. drives the sharded paths as ranks on the one card (sharded_paths
     below): 4 spawned gloo ranks render KillerooP and KillerooV 512^2
     through the queue bands in both layouts (B1), 8 moving frames of
     KillerooP's path with a queue rebuilt a frame, and the G-buffer
     bands (B3); step GoL 2048^2 through the "bits" halos (B4, k = 64)
     and 256^2 through the "pallas" halos (B8, k = 8), BH at 131,072 with
     the distributed sort (B6 as its local sort and merges) and the brute
     step at 8,192; 3 ranks take BH at 98,304 (the odd-even schedule);
     the CLI runs --devices 4 on each experiment; one NCCL rank (world
     size 1) runs the dry run's steps. Frames must equal this process's
     one-rank card frames at 0 px, grids and BH states bit for bit, the
     brute step within 2e-4, PNGs the one-rank frames; each rank's
     launches must be as counted; it prints each rank's wall and
     device-busy ms, labelled as ranks sharing one card (not a scaling
     figure);
  8. drives the port's two top-level surfaces (surfaces below): python -m
     rustexp_tpu_torch.bench in a fresh process, as a user runs it (rc 0,
     a last line that parses with metric raster_suite_Mpix_per_s, 12
     fixed and 12 moving scenes, exactly the keys of the root bench.py's
     full summary, no "partial", each fixed scene timed in 2 runs of 1,024
     frames and its step's launches on stderr exactly 3,072 of its raster
     kernel, B1 or B2; the launches of the whole run count on the main
     path and must include B1, B2, B4, B5 and B6), printing
     its line and wall time; then graft_entry.entry()'s flagship frame on
     the card against the CPU's (0 px, B2 and S launched once).

Its last lines are nvidia-smi's name and power limit, a JSON object of the
kernels (grid launches on the main paths, error, times and each one's
bound; B1's TorusKnotP numbers under "also"),
then {"ok": true, "device": {...}}. It exits non-zero, printing no result,
when there is no CUDA device, a build or launch fails, or a check fails.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

W = H = 512
# (label, mesh, per_pixel, ray_world): ray_world=False is B1's (4, 6) form
B1_SCENES = (("KillerooV", 0, False, True), ("KillerooP", 0, True, True),
             ("TorusKnotV", 6, False, True), ("TorusKnotP", 6, True, True),
             ("KillerooP ray_world=False", 0, True, False))
# B3 at raster_gbuffer_pallas's default bins: (label, mesh, bands). A
# G-buffer carries no attributes, so V and P frames give B3 the same input.
B3_SCENES = (("Killeroo", 0, 1), ("Cube", 9, 1), ("Killeroo 4 bands", 0, 4))
B7_SCENES = (("KillerooP", 0, True), ("KillerooV", 0, False),
             ("TorusKnotP", 6, True))
UNTILEABLE = 500  # an Experiment window of partial tiles: the G-buffer oracle
PATH_FRAMES = 10  # frames per G-buffer or deferred path under the profiler
# (label, mesh, per_pixel, binning): "suite" = suggest_binning's cap and
# spans, as bench_scene renders the Cube; "default" = render_frame's
# backend="pallas" without them (capacity T, dense coverage binning)
B2_SCENES = (("CubeV", 9, False, "suite"), ("CubeP", 9, True, "suite"),
             ("TorusKnotP", 6, True, "default"),
             ("KillerooP", 0, True, "default"))
EXPERIMENT_MESHES = (("Killeroo", 0), ("Cube", 9))
TICKS = (0.0, 0.05, 0.1)
# run_suite in this process (sampling below) over bench.SCENES cut to one
# scene of each raster kernel, KillerooP (B1) and CubeP (B2), beside short
# batches of the same frames: SHORT_RUNS runs of SHORT_FRAMES after a
# one-frame warm-up, no checksum. BENCH_SCENE_RUNS is bench.py's runs
# argument: max(1, 20 // 8) = 2 timed runs of 1,024 frames a scene.
SAMPLING_SCENES = ("KillerooP", "CubeP")
SHORT_RUNS, SHORT_FRAMES = 20, 32
BENCH_SCENE_RUNS = 20
PROFILE_FRAMES = 20  # frames per bench scene under torch.profiler
WALL_RUNS = 5  # unprofiled runs of PROFILE_FRAMES before each profile
GOLDEN_FRAC = 0.003  # tests/test_golden.py: <= 0.3% differing pixels

# The least time the card could take (H100 SXM peak rates): bytes over
# 3.35 TB/s, or the operations over the rate of the pipe that runs them,
# whichever is longer. Rates per SM per clock (Hopper white paper) x 132
# SMs x 1.98 GHz, for work that is not an FMA (the 67 TFLOP/s FP32 peak
# counts an FMA as two).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SM_CLOCKS_PER_S = 132 * 1.98e9
INT_LOGIC_OPS_PER_S = 64 * SM_CLOCKS_PER_S
FP32_NON_FMA_OPS_PER_S = 128 * SM_CLOCKS_PER_S
SFU_OPS_PER_S = 16 * SM_CLOCKS_PER_S
CONVERT_OPS_PER_S = 16 * SM_CLOCKS_PER_S  # int32 -> f32 (I2F)
# Rasters (B1, B2, B3, B7), per (triangle, pixel of its box in the tile),
# as a row of B1's hit loop compiles (SASS of queue_raster_kernel, built
# for sm_90a): integer, e0 and e1 (an IMAD each, the x terms hoisted per
# pair), e2 (IADD3), the sign-OR test (LOP3, ISETP), the two de-biases,
# the tri compare and the z, tri and slot moves (predicated IMAD.MOV);
# FP32, b0 and b2 (FMUL each), z (2 FMUL + 2 FADD), the +inf select and
# the two depth compares; two int -> f32 conversions (I2FP). The box test
# is hoisted per pair and row. Per winning pixel: b1 (an integer de-bias,
# a conversion and an FMUL), then 4 FP32 per two-MAD plane and 5 per
# three-weight plane.
INT_PER_TEST, FP_PER_TEST, CVT_PER_TEST = 11, 9, 2
OPS_2MAD, OPS_3W = 4, 5
# GoL B4: 18 integer instructions per packed word and generation, 2 funnel
# shifts and 16 three-input logic ops (rustexp_tpu/ops/gol_bits.py:54-98
# written as 17; the SASS of csrc/gol_swar.cu's generation loop has 16.0
# LOP3 and 2.0 SHF a word, beside the exchange's 4 SEL and 4 SHFL), at
# the integer pipe's 64 lanes. B8 steps the same function on the same
# packed words (32 cells a word, kernel csrc/gol_stencil.cu), so its least
# work is B4's count per 32 cells and generation. B5: 11 FP32 operations
# per pair (dx and dy, their squares, two adds for d2 + EPS, the product
# with m_j, rm*dx and rm*dy, two sums) at the FP32 rate plus one
# reciprocal on the special-function units, 16 lanes; the pipes run side
# by side, so the bound is the larger time.
OPS_SWAR = 18
OPS_PAIR = 11

# (cells, generations, form): None is the plan's
B4_CASES = (((256, 256), 100, None), ((256, 256), 100, "tiled"),
            ((2048, 2048), 100, None), ((256, 1024), 100, "resident"))
# B8: (cells, generations); the GoL Experiment's "pallas" call is 256^2 x 8
# (GOL_EXPERIMENT_B8), 512^2 x 20 the throughput case
B8_CASES = (((256, 256), 8), ((256, 256), 20), ((512, 512), 20))
GOL_EXPERIMENT_B8 = "256x256 x8"
B5_NS = (16384, 131072, 16385)  # the last not a multiple of 256 targets
# B6: (keys, n); "morton" (the N-body's codes, positions form) is timed
B6_CASES = (("morton", 131072), ("signed", 4096), ("constant", 256),
            ("idx", 4096), ("random", 1 << 20))
# B5 against its plain version: the largest |F_kernel - F_plain| over all
# particles, relative to the largest |F_plain|. The sums run in another
# order (the sun's own force nearly cancels, so a per-particle ratio says
# little there); stated per reciprocal form, measured 7.0e-7 for both at
# N = 131,072 on an H100 with the fused pair and 16 source splits
# (rcp.approx.f32 is within about an ulp).
B5_RTOL = {False: 1e-5, True: 1e-5}
GOL_FRAMES = 4         # Experiment steps per backend, 8 generations each
NBODY_N = 131072
NBODY_STEPS = 3
NBODY_CPU_CASES = ((4096, 0.85), (1024, 0.85), (10_000, 0.85))
NBODY_FRAME_FRAC = 0.01  # tests/test_golden.py's N-body bound
GOL_BENCH_GENS = 65536
NBODY_BENCH_STEPS = {"bh": 16, "pallas": 32}
BENCH_RUNS = 3
# The seeded states (rustexp_tpu_torch/core/prng.py, jax.random's
# threefry2x32). Known answers drawn with jax.random on the CPU (jax
# 0.9.0, jax_threefry_partitionable on, x64 off) and pasted in:
# split(PRNGKey(0)); uniform(PRNGKey(0), (4,)) at the three bounds the
# JAX package draws with, as float32 bits; the GoL Experiment's grid after
# init(n=2048, seed=0) and an R key, its live cells and four 32-cell words
# ((row, first column): cell c of a word at bit c); and
# stable_orbits(PRNGKey(0), 131072)'s particles KAT_ORBITS_AT as float32
# bits, which the port draws within SEEDED_ULPS (XLA:CPU's cos and sin
# are not correctly rounded; the port's are, rustexp_tpu_torch/ops/ieee.py).
KAT_SPLIT = ((1797259609, 2579123966), (928981903, 3453687069))
KAT_UNIFORM = {(0.0, 1.0): (0x3F729A4E, 0x3F7A8436, 0x3EAA221C, 0x3EEFF550),
               (-3.5, 3.5): (0x40488E08, 0x4056675E, 0xBF96444F, 0xBE6095A0),
               (0.1, 1.5): (0x3FB69F36, 0x3FBC2959, 0x3F10B17A, 0x3F41921E)}
SEEDED_GOL_N = 2048
KAT_GOL_LIVE = 2096087
KAT_GOL_WORDS = {(0, 0): 0xD33F757B, (0, 32): 0x15A92FFD,
                 (1024, 1024): 0xD9A68956, (2047, 2016): 0xF59D08A3}
KAT_ORBITS_AT = (1, 2, 3, 131071)
KAT_ORBITS = {"px": (0x41CA92BF, 0x40BA8BF6, 0xC0C8F26F, 0xC15E4332),
              "py": (0x3F94A452, 0x3F4506D5, 0xC061A84D, 0x41B60640),
              "vx": (0xBFB96F7D, 0xC08472AB, 0x4177B6E7, 0xC1D7EBC6),
              "vy": (0x41FCB773, 0x41FACE4E, 0xC1DC96B6, 0xC183D37B)}
SEEDED_ULPS = 2
SEEDED_DISK_N = 10_000   # the W key's disk
SEEDED_GOL_GENS = 8      # one step of the bits_banded Experiment, counted


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


PROFILE_PADS = 4   # spin kernels that open, and that close, each session
PROFILE_TRIES = 12  # sessions tried before a measurement fails
PROFILE_SETTLE_S = 0.02  # least wait after a session opens and before it
PROFILE_SETTLE_MAX_S = 6.4  # closes; the most
settle = PROFILE_SETTLE_S  # the wait the next session starts with
most_settle = 0.0  # the longest wait a kept session had
lost_pads = [0, 0]  # opening and closing pads missing from the records
lost_sessions = 0  # sessions thrown away and tried again


def device_events(fn, reps: int, complete=None) -> list:
    """The card's activities (kernels, copies, sets) that torch.profiler
    saw over `reps` fn() calls, after two warm-up calls.

    On the H100 the card's timestamps drift against the host's clock by
    milliseconds, and the profiler drops every record that falls outside
    the session's window: a session now and then loses the card's records
    at its start, sometimes all of them, while it keeps every launch call
    on the host (`app/profiler_loss.py`). So each session waits on the
    host after it opens and before it closes, and puts PROFILE_PADS short
    spin kernels, each set followed by a synchronize, before and after
    the work; their records are dropped. A pad kept on each side shows
    that no loss reached the work; missing pads count in `lost_pads`.
    A session without both, or whose work fails `complete(events)`, is
    thrown away (counted in `lost_sessions`) and run again, up to
    PROFILE_TRIES sessions. Losses come in spells, so the wait carries
    from one session to the next: doubled after a lost session, halved
    after a kept one, within PROFILE_SETTLE_S and PROFILE_SETTLE_MAX_S."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pads():
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    global lost_sessions, settle, most_settle
    fn()
    fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            pads()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            pads()
            time.sleep(settle)
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        spins = [e.time_range.start for e in events
                 if "spin_kernel" in e.name]
        work = [e for e in events if "spin_kernel" not in e.name]
        starts = [e.time_range.start for e in work] or [0.0]
        kept = (sum(t < min(starts) for t in spins),
                sum(t > max(starts) for t in spins))
        for side in (0, 1):
            lost_pads[side] += PROFILE_PADS - kept[side]
        if work and all(kept) and (complete is None or complete(work)):
            most_settle = max(most_settle, settle)
            settle = max(settle / 2, PROFILE_SETTLE_S)
            return work
        lost_sessions += 1
        settle = min(2 * settle, PROFILE_SETTLE_MAX_S)
    raise RuntimeError(f"{PROFILE_TRIES} profiling sessions in a row lost "
                       f"their records")


def device_ms(fn, reps: int, kernel: str | None, per_call: int | None = 1
              ) -> float:
    """Mean device milliseconds per fn() call of the CUDA kernels whose
    name contains `kernel`, or of all the card's activities (kernels,
    copies, sets) for None. A session counts only if it holds `per_call`
    of them per call (None: a whole number above 0). Unlike CUDA events
    around back-to-back calls, this does not count the host's launch time
    when a kernel is shorter than it."""
    def spans(events):
        return [e.time_range.end - e.time_range.start for e in events
                if kernel is None or kernel in e.name]

    def complete(events):
        got = len(spans(events))
        return (got == per_call * reps if per_call else
                got > 0 and got % reps == 0)

    return sum(spans(device_events(fn, reps, complete))) / 1e3 / reps


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


def frame_breakdowns(bench) -> list[dict]:
    """Per bench scene, where a frame's time goes on the card: device-busy
    ms, device activities and raster-kernel ms per frame, by the profiler
    over PROFILE_FRAMES frames, and the idle share against the scene's
    median ms a frame unprofiled, in WALL_RUNS runs of PROFILE_FRAMES
    frames (CUDA events) just before the profile in this process (the
    profiler's own host overhead stretches a profiled frame's wall
    time)."""
    out = []
    for label, mesh_idx, per_pixel, _ in bench.SCENES:
        frame, structure, _, _ = bench.scene_frame(mesh_idx, per_pixel,
                                                   torch.device("cuda"))

        def frames():
            for _ in range(PROFILE_FRAMES):
                frame()

        frame()
        wall = bench._run_stats(lambda: bench._event_seconds(frames),
                                WALL_RUNS, PROFILE_FRAMES)["median"] * 1e3
        events = device_events(frame, PROFILE_FRAMES)
        busy = busy_ms(events) / PROFILE_FRAMES
        raster = sum(e.time_range.end - e.time_range.start for e in events
                     if "raster_kernel" in e.name) / 1e3 / PROFILE_FRAMES
        out.append(dict(scene=label, backend=structure["backend"],
                        wall_ms=wall, busy_ms=busy, idle=1.0 - busy / wall,
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
    """(bound_ms, bound_by) of one raster call: `tests` (triangle, pixel)
    tests inside the boxes, `won` pixels whose n2 + n3 planes are
    evaluated; the integer, FP32 and conversion pipes run side by side."""
    t_ops = max((tests * INT_PER_TEST + won) / INT_LOGIC_OPS_PER_S,
                (tests * FP_PER_TEST + won * (1 + OPS_2MAD * n2 + OPS_3W * n3))
                / FP32_NON_FMA_OPS_PER_S,
                (tests * CVT_PER_TEST + won) / CONVERT_OPS_PER_S)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
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


def queue_args(pp, rq, scene, queue, eye, per_pixel: bool,
               ray_world: bool = True):
    """B1's arguments (scal, rows_i, rows_f, n2, n3, H, W) on `queue` at
    `eye`, tick 0, as the queue path makes them (B7 takes the same but n2
    and n3)."""
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H,
                                                     5)
    setup, extra, n2, n3 = pp.queue_attr_channels(
        scene, colors, eye, W, H, per_pixel=per_pixel, ray_world=ray_world)
    rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
    return queue.scal, rows_i, rows_f, n2, n3, H, W


def queue_inputs(dev, pp, rq, meshes, cubemap, camera, mesh_idx, per_pixel,
                 ray_world=True):
    """queue_args on the scene's build_scene_queue queue at 512x512,
    tick 0."""
    scene = pp.make_scene(meshes.get_mesh(mesh_idx), cubemap.get_cm_set(0),
                          dev)
    eye = camera.camera_eye(meshes.mesh_camera(mesh_idx), 0.0)
    queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
    return queue_args(pp, rq, scene, queue, eye, per_pixel, ray_world)


def b1_work(rq, scal, rows_i, rows_f, n2, n3, covered):
    """(bound_ms, bound_by, live pairs, box tests) of one B1 call: each
    live pair's channels read once, every output plane written once."""
    live = (torch.arange(rq.CHUNK, device=scal.device)[None, :]
            < scal[:, 3:4])                                      # [S, CHUNK]
    pairs = int(live.sum())
    rec = rows_i.permute(0, 2, 1)                            # [S, CHUNK, 12]
    tests = int((box_px(rec, (scal[:, 1] * rq.TILE_W)[:, None],
                        (scal[:, 4] * rq.TILE_H)[:, None], rq.TILE_H,
                        rq.TILE_W) * live).sum())
    planes = 2 + n2 + n3
    bytes_moved = (scal.numel() * 4 + pairs * (rows_i.shape[1]
                                               + rows_f.shape[1]) * 4
                   + planes * (H + rq.TILE_H) * W * 4)
    bms, by = bound(bytes_moved, tests, covered, n2, n3)
    return bms, by, pairs, tests


def b1_check(dev, rq, label: str, args, timed: bool = True) -> dict:
    """B1 against its plain version on one queue's arguments (z and planes
    under the coverage mask, slot on every word); with `timed`, its time
    by all the card's activity of a call, its wrapper call's and plain
    version's by CUDA events, and its bound. Returns the record."""
    n2, n3 = args[3:5]
    calls = rq.raster_attrs_queue_cuda.launches
    zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
    calls = rq.raster_attrs_queue_cuda.launches - calls
    zp, sp, lp = rq.raster_attrs_queue_plain(*args)
    torch.cuda.synchronize(dev)
    mask = sp >= 0
    bad = bit_mismatches(zk, sk, lk, zp, sp, lp, mask)
    err = max_abs_err(zk, lk, zp, lp, mask)
    covered = int(mask.sum())
    bms, by, pairs, tests = b1_work(rq, *args[:5], covered)
    rec = dict(err=err, bad=bad, covered=covered)
    if timed:
        run = lambda: rq.raster_attrs_queue_cuda(*args)
        rec.update(ms=device_ms(run, 50, None, calls),
                   call_ms=cuda_ms(run, 50),
                   plain_ms=cuda_ms(
                       lambda: rq.raster_attrs_queue_plain(*args), 5),
                   bound_ms=bms, bound_by=by, launches_per_call=calls,
                   work=f"{pairs} pairs, {tests} box tests, {calls} grid "
                        f"launches a call")
    print(f"B1 {label}: {covered} covered px, {pairs} pairs, {tests} "
          f"box tests, n2={n2} n3={n3}, {calls} grid launches a call: "
          f"{bad} mismatching words, max_abs_err {err}", flush=True)
    return rec


def b1_vs_plain(dev, pp, rq, meshes, cubemap, camera):
    """B1 against its plain version at the main path's shapes, timed by
    all the card's activity of a call. Returns {label: record}."""
    return {label: b1_check(dev, rq, label, queue_inputs(
                dev, pp, rq, meshes, cubemap, camera, mesh_idx, per_pixel,
                ray_world))
            for label, mesh_idx, per_pixel, ray_world in B1_SCENES}


# The stress queue of kernel B1's depth race, hand-built. One crowded
# 16x128 tile holds STRESS_CHUNKS full chunks of pairs, so a kernel that
# splits a tile's pairs must merge partial winners, and next to it a tile
# whose chunks are all empty. Random triangles fill the left three
# quarters of the crowded tile; among them, at slots spread across every
# chunk: coplanar copies of one triangle under different ids (ids not in
# slot order) whose depth is exactly 1.0 on the right quarter, where
# nothing else lies, so they tie with each other and beat the depth clear
# (1.0, INT32_MAX) there; coplanar copies of another at depth 0, some
# carrying -0.0 and some +0.0 (the z channels of their slots set by hand),
# so they tie and the lowest id's own zero is the stored depth; and one
# triangle id in two slots, drawn in front of everything, whose first slot
# keeps the pixel. tests/test_torch_cuda.py holds B1 against its plain
# version on it, tests/test_torch_queue.py the plain race against a
# serial walk.
STRESS_CHUNKS = 16
STRESS_H, STRESS_W = 16, 256  # the crowded tile, and the tile of empty chunks
N_COPIES = 7


def _stress_triangles(rng, n: int, x_lo: float, x_hi: float,
                      size: float, w: int = STRESS_W, h: int = STRESS_H):
    """Corner coordinates f32 [3, n] of triangles that the setup keeps
    (counter-clockwise, with pixels in the w x h frame) about [x_lo, x_hi)
    x [0, h)."""
    import numpy as np

    from rustexp_tpu_torch.ops.raster_setup import setup_triangles_planar

    m = 2 * n
    cx = rng.uniform(x_lo, x_hi, m)
    cy = rng.uniform(0.0, h, m)
    xs = (cx + rng.uniform(-size, size, (3, m))).astype(np.float32)
    ys = (cy + rng.uniform(-size, size, (3, m))).astype(np.float32)
    area = ((xs[1] - xs[0]) * (ys[2] - ys[0])
            - (ys[1] - ys[0]) * (xs[2] - xs[0]))
    flip = area < 0
    xs[1][flip], xs[2][flip] = xs[2][flip], xs[1][flip].copy()
    ys[1][flip], ys[2][flip] = ys[2][flip], ys[1][flip].copy()
    valid = setup_triangles_planar(torch.from_numpy(xs), torch.from_numpy(ys),
                                   torch.zeros((3, m)), w,
                                   h).valid.numpy()
    keep = np.flatnonzero(valid)[:n]
    assert keep.size == n
    return xs[:, keep], ys[:, keep]


def stress_queue(n2: int, n3: int, device, seed: int = 0):
    """(scal, rows_i, rows_f, h, w) of the stress queue for B1's (n2, n3)
    form, on `device`; the attribute planes are random."""
    import numpy as np

    from rustexp_tpu_torch.ops import raster_queue as rq
    from rustexp_tpu_torch.ops.raster_setup import setup_triangles_planar

    rng = np.random.default_rng(seed)
    n_pairs = STRESS_CHUNKS * rq.CHUNK
    n_rand = n_pairs - 2 * N_COPIES - 2
    xs_r, ys_r = _stress_triangles(rng, n_rand, 0.0, 96.0, 6.0)
    zs_r = np.repeat(rng.uniform(0.05, 0.95, (1, n_rand)), 3, 0)
    # the copies: one at depth 1.0 over x 100..128, one at 0 over x 0..40
    one = (np.array([[100.0], [127.9], [100.0]]), np.array([[-1.0], [-1.0],
                                                            [17.0]]))
    zero = (np.array([[0.5], [40.0], [0.5]]), np.array([[3.0], [3.0],
                                                        [13.0]]))
    dup = (np.array([[50.0], [70.0], [50.0]]), np.array([[2.0], [2.0],
                                                         [15.0]]))
    xs = np.concatenate([xs_r, np.repeat(one[0], N_COPIES, 1),
                         np.repeat(zero[0], N_COPIES, 1), dup[0]], 1)
    ys = np.concatenate([ys_r, np.repeat(one[1], N_COPIES, 1),
                         np.repeat(zero[1], N_COPIES, 1), dup[1]], 1)
    zs = np.concatenate([zs_r, np.ones((3, N_COPIES)),
                         np.zeros((3, N_COPIES)), np.full((3, 1), 0.01)], 1)
    n_tri = xs.shape[1]
    setup = setup_triangles_planar(
        *(torch.from_numpy(a.astype(np.float32)) for a in (xs, ys, zs)),
        STRESS_W, STRESS_H)
    assert bool(setup.valid.all())
    extra = [torch.from_numpy(rng.normal(size=n_tri).astype(np.float32))
             for _ in range(3 * (n2 + n3))]

    # slot -> triangle id: the copies' slots interleave over every chunk,
    # their ids shuffled; the duplicated id sits in chunks 2 and 13
    spread = np.linspace(5, n_pairs - 5, 2 * N_COPIES).astype(int)
    one_slots, zero_slots = spread[0::2], spread[1::2]
    dup_slots = np.array([2 * rq.CHUNK + 77, 13 * rq.CHUNK + 3])
    ids = np.full(n_pairs, -1, np.int64)
    ids[one_slots] = n_rand + rng.permutation(N_COPIES)
    ids[zero_slots] = n_rand + N_COPIES + rng.permutation(N_COPIES)
    ids[dup_slots] = n_tri - 1
    free = ids < 0
    ids[free] = rng.permutation(n_rand)[:int(free.sum())]

    n_ch = STRESS_CHUNKS + 3
    all_ids = np.full((n_ch, rq.CHUNK), -1, np.int32)
    all_ids[:STRESS_CHUNKS] = ids.reshape(STRESS_CHUNKS, rq.CHUNK)
    scal = np.zeros((n_ch, 5), np.int32)
    scal[:STRESS_CHUNKS] = (0, 0, 0, rq.CHUNK, 0)
    scal[0, 2] = 1
    scal[STRESS_CHUNKS] = (0, 1, 1, 0, 0)       # a tile of empty chunks
    scal[STRESS_CHUNKS + 1] = (0, 1, 0, 0, 0)
    scal[STRESS_CHUNKS + 2] = (STRESS_H // rq.TILE_H, 0, 1, 0,
                                STRESS_H // rq.TILE_H)
    queue = rq.Queue(torch.from_numpy(all_ids), torch.from_numpy(scal),
                     *[None] * 6, shade_w=rq.TILE_W)
    rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
    # the depth-0 copies alternate -0.0 and +0.0, the lowest id on -0.0
    sign = np.where(np.arange(N_COPIES) % 2 == 0, -0.0, 0.0)
    sign[np.argmin(ids[zero_slots])] = -0.0
    for s, z in zip(zero_slots, sign):
        rows_f[s // rq.CHUNK, 3:6, s % rq.CHUNK] = float(z)
    dev = torch.device(device)
    return (queue.scal.to(dev), rows_i.to(dev), rows_f.to(dev), STRESS_H,
            STRESS_W)


def b1_stress(dev, rq) -> int:
    """B1 against its plain version on the stress queue (stress_queue) in
    each (n2, n3) form: slot on every word, z and
    planes under slot >= 0, the clear (z 1.0, planes 0) elsewhere.
    Returns the mismatching words."""
    bad = 0
    for n2, n3 in rq._B1_PLANES:
        args = stress_queue(n2, n3, dev)
        args = args[:3] + (n2, n3) + args[3:]
        zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
        zp, sp, lp = rq.raster_attrs_queue_plain(*args)
        torch.cuda.synchronize(dev)
        mask = sp >= 0
        words = bit_mismatches(zk, sk, lk, zp, sp, lp, mask)
        words += int((zk[~mask] != 1.0).sum() + (lk[:, ~mask] != 0.0).sum())
        print(f"B1 stress queue n2={n2} n3={n3}: {int(mask.sum())} covered "
              f"px of {tuple(sk.shape)}: {words} mismatching words",
              flush=True)
        bad += words
    return bad


# The stress bins of kernel B3's depth race, hand-built on one row of three
# 32x128 tiles (cap 1,280). Tile 0 is crowded: 1,163 live slots, so a
# kernel that splits a tile's slots must merge partial winners, past one
# 256-slot stage and past 4 warps x 32. Random small triangles fill its
# left three quarters (each box meets few 4x32 rectangles); among them, at
# slots spread over the whole bin: coplanar copies at depth exactly 1.0 on
# the right quarter, where nothing else lies, which tie and never beat the
# clear (1.0, -1); coplanar copies at depth 0 over two regions, their z
# channels set by hand to +0.0 and -0.0 in turn, the first slot carrying
# +0.0 over one region and -0.0 over the other, so they tie and the first
# slot keeps the pixel with its own zero; and one triangle in two slots,
# in front of everything, whose first slot keeps the pixel. Tile 1 is empty
# (count 0) over slots that hold live triangles, and tile 2 holds 37 live
# slots. Past each count, up to a multiple of 8, the slots are the empty
# record (a box that admits no pixel), as the binning leaves them and as
# the TPU kernel's groups of 8 read them; past that they hold live
# triangles in front of everything, which only a race that ignored the
# count would draw. tests/test_torch_cuda.py holds B3 against its plain
# version on them, tests/test_torch_gbuffer.py the plain B3 against the
# TPU kernel in interpret mode.
BINS_H, BINS_W, BINS_CAP = 32, 384, 1280
BINS_COUNTS = (1163, 0, 37)


def stress_bins(device, seed: int = 0):
    """(bins, h, w): the stress bins as a BinnedTris on `device`, made from
    numpy arrays by interop.bins_from_numpy."""
    import numpy as np

    from rustexp_tpu_torch import interop
    from rustexp_tpu_torch.ops import raster_queue as rq
    from rustexp_tpu_torch.ops.raster_setup import setup_triangles_planar

    rng = np.random.default_rng(seed)
    n0, n2 = BINS_COUNTS[0], BINS_COUNTS[2]
    # the first slot past each count's multiple of 8
    end0, end2 = -(-n0 // 8) * 8, -(-n2 // 8) * 8

    def tris(n, x_lo, x_hi, size, z_lo, z_hi):
        xs, ys = _stress_triangles(rng, n, x_lo, x_hi, size, BINS_W, BINS_H)
        return xs, ys, np.repeat(rng.uniform(z_lo, z_hi, (1, n)), 3, 0)

    def copies(n, xs, ys, z):
        return (np.repeat(np.array(xs, np.float32)[:, None], n, 1),
                np.repeat(np.array(ys, np.float32)[:, None], n, 1),
                np.full((3, n), z, np.float32))

    n_copy = 7
    n_rand = n0 - 3 * n_copy - 2
    groups = [
        tris(n_rand, 0.0, 96.0, 6.0, 0.05, 0.95),                 # tile 0
        copies(n_copy, (100.0, 127.9, 100.0), (-1.0, -1.0, 33.0), 1.0),
        copies(n_copy, (0.5, 40.0, 0.5), (1.0, 1.0, 15.0), 0.0),
        copies(n_copy, (0.5, 40.0, 0.5), (17.0, 17.0, 31.0), 0.0),
        copies(1, (50.0, 70.0, 50.0), (2.0, 2.0, 30.0), 0.01),
        tris(BINS_CAP - end0, 0.0, 128.0, 10.0, 0.0, 0.004),      # stale
        tris(n2, 256.0, 384.0, 30.0, 0.1, 0.9),                   # tile 2
        tris(BINS_CAP - end2, 256.0, 384.0, 30.0, 0.0, 0.004),    # stale
        tris(BINS_CAP, 128.0, 256.0, 20.0, 0.0, 0.9)]             # tile 1
    xs, ys, zs = (np.concatenate([g[i] for g in groups], 1) for i in range(3))
    start = np.cumsum([0] + [g[0].shape[1] for g in groups])
    setup = setup_triangles_planar(
        *(torch.from_numpy(a.astype(np.float32)) for a in (xs, ys, zs)),
        BINS_W, BINS_H)
    assert bool(setup.valid.all())
    tab = rq.pack_table(setup, []).numpy()  # its last row: the empty record

    # tile 0: the copies' slots spread over the bin, their order shuffled;
    # the duplicate in slots 211 and 1002, which a kernel that deals slots
    # out to 2 or 4 warps gives to different warps; the random triangles
    # in the rest
    ids = np.full((len(BINS_COUNTS), BINS_CAP), tab.shape[0] - 1, np.int64)
    special = np.linspace(3, n0 - 3, 3 * n_copy).astype(int)
    dup = np.array([211, 1002])
    assert not np.isin(dup, special).any()
    ids[0, special] = start[1] + rng.permutation(3 * n_copy)
    ids[0, dup] = start[4]
    free = np.setdiff1d(np.arange(n0), np.concatenate([special, dup]))
    ids[0, free] = start[0] + rng.permutation(n_rand)
    ids[0, end0:] = start[5] + np.arange(BINS_CAP - end0)
    ids[1] = start[8] + np.arange(BINS_CAP)
    ids[2, :n2] = start[6] + np.arange(n2)
    ids[2, end2:] = start[7] + np.arange(BINS_CAP - end2)
    rec = tab[ids]                                           # [3, cap, 19]
    setup_i = np.ascontiguousarray(rec[..., :12]).view(np.int32)
    setup_f = np.ascontiguousarray(rec[..., 12:19])
    # the depth-0 copies' z channels: +0.0 and -0.0 in turn in slot order,
    # from +0.0 over the upper region and from -0.0 over the lower
    for g, first in ((2, 1.0), (3, -1.0)):
        slots = np.flatnonzero((ids[0, :n0] >= start[g])
                               & (ids[0, :n0] < start[g + 1]))
        for j, sl in enumerate(slots):
            setup_f[0, sl, 3:6] = np.copysign(np.float32(0.0),
                                              first * (-1) ** j)
    d = dict(setup_i=setup_i, setup_f=setup_f, ids=ids.astype(np.int32),
             counts=np.array(BINS_COUNTS, np.int32),
             overflow=np.array(False))
    return interop.bins_from_numpy(d, device), BINS_H, BINS_W


def dim_cube_maps(gen) -> torch.Tensor:
    """A [5, 6, 64, 64, 3] cube-map set drawn from `gen` whose powers
    cos^0, 1, 8, 64, 512 stay below 0.3, 0.3, 0.06, 0.01 and 0.0012: the
    shaders weight them 1, 1, 5, 33 and 257, so their channels stay below
    white (shade_inputs)."""
    return torch.rand(5, 6, 64, 64, 3, generator=gen) * torch.tensor(
        [0.3, 0.3, 0.06, 0.01, 0.0012])[:, None, None, None, None]


def shade_inputs(h: int, w: int, per_pixel: bool, ray_world: bool, device,
                 seed: int = 0, block_w: int = 64, degenerate: bool = False):
    """(mask, z, lin, bg, cm, rows): synthetic inputs of the shade
    (raster/shade.py) on `device`. 1/w in [0.3, 1), colours in [0.1, 0.6)
    times 1/w, world positions and normals in [-1, 1) times 1/w, z in
    [-1, 1), 80% of the pixels covered, and a cube-map set whose powers
    cos^0, 1, 8, 64, 512 stay below 0.3, 0.3, 0.06, 0.01 and 0.0012 (the
    shaders weight them 1, 1, 5, 33 and 257): small enough that the
    shaders' channels stay below white (but where CMDiffRim's Fresnel term
    passes 1, on normals facing away), so the gamma pack tells shading
    apart (the stand-in sky sends CMRefl past white). `rows`
    lists two thirds of the block_w-wide blocks, ascending, then 5 pads.
    `degenerate` puts 1/w 0, -0 and inf, a NaN and a negative colour, and
    zero normals in a few covered pixels."""
    gen = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=gen)

    n_planes = 4 if not per_pixel else (7 if ray_world else 10)
    iw = 0.3 + 0.7 * u(h, w)
    lin = [iw] + [(0.1 + 0.5 * u(h, w)) * iw for _ in range(3)]
    lin += [(2.0 * u(h, w) - 1.0) * iw for _ in range(n_planes - 4)]
    mask = u(h, w) < 0.8
    if degenerate:
        lin[0][0, :3] = torch.tensor([0.0, -0.0, float("inf")])
        lin[1][1, :2] = torch.tensor([float("nan"), -5.0])
        for p_ in lin[4:]:
            p_[2, :3] = 0.0
        mask[:3, :3] = True
    z = 2.0 * u(h, w) - 1.0
    bg = torch.randint(0, 1 << 24, (h, w), generator=gen, dtype=torch.int32)
    cm = dim_cube_maps(gen)
    n_blk = h * (w // block_w)
    listed = torch.randperm(n_blk, generator=gen)[:n_blk * 2 // 3].sort()[0]
    rows = torch.cat([listed, torch.full((5,), n_blk)]).to(torch.int32)
    return tuple(t.to(device) if isinstance(t, torch.Tensor)
                 else [p_.to(device) for p_ in t]
                 for t in (mask, z, lin, bg, cm, rows))


S_SCENES = (("KillerooP", 0), ("CubeP", 9))  # the benchmark cells' scenes
SECTOR = 32  # bytes: the least the card moves between HBM and L2


def shade_call(bench, sd, mesh_idx: int, dev) -> tuple:
    """(args, keywords) of the shade kernel's call in one frame of a bench
    scene (scene_frame's frame(), per pixel): the shapes, rows list,
    coverage and planes the main path hands it."""
    frame = bench.scene_frame(mesh_idx, True, dev)[0]
    frame()
    calls, orig = [], sd.shade_pack_cuda

    def record(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    record.launches = orig.launches
    sd.shade_pack_cuda = record
    try:
        frame()
    finally:
        orig.launches = record.launches
        sd.shade_pack_cuda = orig
    if len(calls) != 1:
        raise RuntimeError(f"a frame of mesh {mesh_idx} called the shade "
                           f"kernel {len(calls)} times")
    return calls[0]


def _sectors(words: torch.Tensor, per: int) -> int:
    """SECTOR-byte sectors of a flat array that hold a needed element:
    `words` flags them, `per` elements a sector."""
    flat = words.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.reshape(-1, per).any(dim=1).sum())


def s_bytes(mask, lin, bg, rows, block_w, rays: bool) -> tuple:
    """(bytes, walked, covered, pad entries) of one shade call: the least
    it moves to and from HBM, in whole sectors, and the flat flags of the
    pixels it walks (every pixel, or a listed block's) and of those
    covered. Counted: the rows list; the mask where a pixel is walked; the
    planes, and z with rays, where a walked pixel is covered; the
    background where a walked pixel is not covered, and the frame written
    once; with a rows list, the background's copy into the frame (read
    and write, every word) and the covered words written over it. The cube
    map and the gamma curve (1.5 MB and 8 KB, the same every call) are
    left out."""
    h, w = bg.shape
    walked = torch.ones(h * w, dtype=torch.bool, device=bg.device)
    pads = nbytes = 0
    if rows is not None:
        n_blk = h * (w // block_w)
        listed = rows[rows < n_blk].long()
        pads = rows.shape[0] - listed.shape[0]
        walked = torch.zeros(n_blk, dtype=torch.bool, device=bg.device)
        walked[listed] = True
        walked = walked[:, None].expand(n_blk, block_w).reshape(-1)
        nbytes += _sectors(torch.ones_like(rows, dtype=torch.bool), 8)
    covered = walked & mask.reshape(-1)
    planes = len(lin) + (1 if rays else 0)
    nbytes += _sectors(walked, SECTOR) + planes * _sectors(covered, 8)
    if rows is None:
        nbytes += _sectors(walked & ~covered, 8) + h * w * 4 // SECTOR
    else:
        nbytes += 2 * h * w * 4 // SECTOR + _sectors(covered, 8)
    return nbytes * SECTOR, walked, covered, pads


def s_vs_plain(dev, bench, sd) -> dict:
    """The shade kernel (S) against its plain version on each S_SCENES
    scene's call as the main path makes it (shade_call: the sphere's
    ray-world rows list, CubeP's whole frame of 10 planes), with the cube
    maps swapped for dim ones (dim_cube_maps) so that no channel reaches
    white: 0 differing words against the plain chain on the card and on
    the CPU. Timed by all the card's activity of a call (with a rows list
    the background's copy and the grid), the grid alone, CUDA events
    around back-to-back calls, and the plain chain on the card; the bound
    is s_bytes over the memory rate. Returns {label: record}."""
    out = {}
    for label, mesh_idx in S_SCENES:
        (mask, z, lin, bg, _, eye), kw = shade_call(bench, sd, mesh_idx, dev)
        cm = dim_cube_maps(torch.Generator().manual_seed(mesh_idx)).to(dev)
        args = (mask, z, lin, bg, cm, eye)
        calls = sd.shade_pack_cuda.launches
        got = sd.shade_pack_cuda(*args, **kw)
        calls = sd.shade_pack_cuda.launches - calls
        card = sd.shade_pack_plain(*args, bench.TICK, **kw)
        cpu_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items()}
        cpu = sd.shade_pack_plain(
            mask.cpu(), None if z is None else z.cpu(),
            [p_.cpu() for p_ in lin], bg.cpu(), cm.cpu(), eye, bench.TICK,
            **cpu_kw)
        bad = int((got != card).sum()) + int((got.cpu() != cpu).sum())
        rows = kw.get("rows")
        rays = kw["per_pixel"] and kw["ray_world"]
        nbytes, walked, covered, pads = s_bytes(
            mask, lin, bg, rows, kw.get("block_w"), rays)
        words = got.reshape(-1)[covered]
        white = int(torch.stack([(words >> s_) & 0xFF == 255
                                 for s_ in (0, 8, 16)]).any(dim=0).sum())
        walked, covered = int(walked.sum()), int(covered.sum())
        form = ("whole frame" if rows is None
                else f"rows list of {rows.shape[0]}")
        bms, by = time_bound(nbytes, 0)
        run = lambda: sd.shade_pack_cuda(*args, **kw)
        print(f"S {label}: {form}, {len(lin)} planes, rays {rays}: "
              f"{covered} covered px of {walked} walked, {pads} pad "
              f"entries, {white} covered px with a channel at 255; "
              f"{calls} grid launches a call: {bad} words differ from the "
              f"plain chain (card and CPU)", flush=True)
        out[label] = dict(
            err=float(bad), bad=bad, covered=covered,
            ms=device_ms(run, 50, None, 1 if rows is None else 2),
            kernel_ms=device_ms(run, 50, "shade_pack_kernel"),
            call_ms=cuda_ms(run, 50),
            plain_ms=cuda_ms(lambda: sd.shade_pack_plain(
                *args, bench.TICK, **kw), 5),
            bound_ms=bms, bound_by=by, launches_per_call=calls,
            work=(f"{form}, {len(lin)} planes{' and z' if rays else ''}, "
                  f"{walked} px walked, {covered} covered, {pads} pad "
                  f"entries, {white} covered px with a channel at 255, "
                  f"{nbytes} B"))
    return out


def b3_stress(dev, rb) -> int:
    """B3 against its plain version on the stress bins (stress_bins), bit
    for bit on every word. Returns the mismatching words."""
    bins, h, w = stress_bins(dev)
    args = (bins.counts, bins.setup_i, bins.setup_f, h, w)
    zk, sk, bk = rb.raster_gbuffer_bins_cuda(*args)
    zp, sp, bp = rb.raster_gbuffer_bins_plain(*args)
    torch.cuda.synchronize(dev)
    words = int((sk != sp).sum())
    words += int((zk.view(torch.int32) != zp.view(torch.int32)).sum())
    words += int((bk.view(torch.int32) != bp.view(torch.int32)).sum())
    print(f"B3 stress bins: counts {bins.counts.tolist()} (cap "
          f"{bins.setup_i.shape[1]}), {int((sp >= 0).sum())} covered px of "
          f"{tuple(sp.shape)}, {int((sp >= 1024).sum())} won past slot "
          f"1,023: {words} mismatching words", flush=True)
    return words


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


def b3_vs_plain(dev, pp, rb, setup_triangles, meshes, cubemap, camera):
    """B3 against its plain version at raster_gbuffer_pallas's default
    bins, whole 512x512 frames and four 128-row bands (y_shift), bit for
    bit on every word. Returns {label: record}."""
    out = {}
    for label, mesh_idx, n_bands in B3_SCENES:
        scene = pp.make_scene(meshes.get_mesh(mesh_idx),
                              cubemap.get_cm_set(0), dev)
        eye = camera.camera_eye(meshes.mesh_camera(mesh_idx), 0.0)
        vp, _, _ = pp.transform_vertices(scene, eye, W, H)
        band_h = H // n_bands
        calls = []
        for b in range(n_bands):
            setup = setup_triangles(vp, scene.tris, W, band_h,
                                    y_shift=b * band_h)
            bins = rb.bin_triangles(setup, band_h, W,
                                    rb._bins_cap(setup.A.shape[0], None))
            if bool(bins.overflow):
                raise RuntimeError(f"B3 {label}: the bins overflowed")
            calls.append((bins.counts, bins.setup_i, bins.setup_f, band_h, W))
        bad = covered = slots = tests = bytes_moved = 0
        err = 0.0
        ntx = W // rb.TILE_W
        for args in calls:
            zk, sk, bk = rb.raster_gbuffer_bins_cuda(*args)
            zp, sp, bp = rb.raster_gbuffer_bins_plain(*args)
            torch.cuda.synchronize(dev)
            bad += int((sk != sp).sum())
            bad += int((zk.view(torch.int32) != zp.view(torch.int32)).sum())
            bad += int((bk.view(torch.int32) != bp.view(torch.int32)).sum())
            err = max(err, float((zk - zp).abs().max()),
                      float((bk - bp).abs().max()))
            covered += int((sp >= 0).sum())
            counts, setup_i, setup_f = args[:3]
            n_tiles, cap, _ = setup_i.shape
            live = (torch.arange(cap, device=dev)[None, :]
                    < counts[:, None])                            # [nT, cap]
            tiles = torch.arange(n_tiles, device=dev)
            slots += int(live.sum())
            tests += int((box_px(setup_i, ((tiles % ntx) * rb.TILE_W)[:, None],
                                 ((tiles // ntx) * rb.TILE_H)[:, None],
                                 rb.TILE_H, rb.TILE_W) * live).sum())
            bytes_moved += (counts.numel() * 4
                            + int(live.sum()) * (setup_i.shape[2]
                                                 + setup_f.shape[2]) * 4
                            + 5 * band_h * W * 4)
        bms, by = bound(bytes_moved, tests, covered, 0, 0)
        run = lambda: [rb.raster_gbuffer_bins_cuda(*a) for a in calls]
        out[label] = dict(
            err=err, bad=bad, covered=covered,
            ms=device_ms(run, 20, "bins_gbuffer_kernel", None),
            call_ms=cuda_ms(run, 20),
            plain_ms=cuda_ms(
                lambda: [rb.raster_gbuffer_bins_plain(*a) for a in calls], 3),
            bound_ms=bms, bound_by=by,
            work=f"{slots} slots in {n_bands} call(s), cap "
                 f"{calls[0][1].shape[1]}")
        print(f"B3 {label}: {covered} covered px, {slots} bin slots in "
              f"{n_bands} call(s): {bad} mismatching words, max_abs_err "
              f"{err}", flush=True)
    return out


def b7_check(dev, rq, label: str, args) -> dict:
    """B7 against its plain version on one queue's (scal, rows_i, rows_f,
    h, w): z and slot on every word (the clear, z 1.0 and slot -1, where
    no pair won), timed by all the card's activity of a call. Returns the
    record."""
    scal, rows_i, rows_f = args[:3]
    calls = rq.raster_zslot_queue_cuda.launches
    zk, sk = rq.raster_zslot_queue_cuda(*args)
    calls = rq.raster_zslot_queue_cuda.launches - calls
    zp, sp = rq.raster_zslot_queue_plain(*args)
    torch.cuda.synchronize(dev)
    won = sp >= 0
    bad = zslot_mismatches(zk, sk, zp, sp)
    err = float((zk - zp).abs().max())
    live = (torch.arange(rq.CHUNK, device=dev)[None, :]
            < scal[:, 3:4])                                      # [S, CHUNK]
    pairs = int(live.sum())
    rec = rows_i.permute(0, 2, 1)                            # [S, CHUNK, 12]
    tests = int((box_px(rec, (scal[:, 1] * rq.TILE_W)[:, None],
                        (scal[:, 4] * rq.TILE_H)[:, None], rq.TILE_H,
                        rq.TILE_W) * live).sum())
    # the race reads 12 int and 7 float channels of a live pair
    bytes_moved = (scal.numel() * 4 + pairs * (rows_i.shape[1] + 7) * 4
                   + zk.numel() * 4 + sk.numel() * 4)
    bms, by = bound(bytes_moved, tests, 0, 0, 0)
    run = lambda: rq.raster_zslot_queue_cuda(*args)
    print(f"B7 {label}: {int(won.sum())} covered px, {pairs} pairs, "
          f"{calls} grid launches a call: {bad} mismatching words, "
          f"max_abs_err {err}", flush=True)
    return dict(
        err=err, bad=bad, covered=int(won.sum()),
        ms=device_ms(run, 50, None, calls), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: rq.raster_zslot_queue_plain(*args), 5),
        bound_ms=bms, bound_by=by, launches_per_call=calls,
        work=f"{pairs} pairs, {tests} box tests, {calls} grid launches a "
             f"call")


def b7_vs_plain(dev, pp, rq, meshes, cubemap, camera):
    """B7 against its plain version on the scene's queue at 512x512 (B1's
    arguments but the planes). Returns {label: record}."""
    out = {}
    for label, mesh_idx, per_pixel in B7_SCENES:
        scal, rows_i, rows_f, _, _, h, w = queue_inputs(
            dev, pp, rq, meshes, cubemap, camera, mesh_idx, per_pixel)
        out[label] = b7_check(dev, rq, label, (scal, rows_i, rows_f, h, w))
    return out


def zslot_mismatches(zk, sk, zp, sp) -> int:
    """Words of (z, slot) that differ, both on every word."""
    return int((sk != sp).sum()) + int(
        (zk.view(torch.int32) != zp.view(torch.int32)).sum())


def b7_stress(dev, rq) -> int:
    """B7 against its plain version on the stress queue (stress_queue in
    its (4, 0) form): z and slot on every word. Returns the mismatching
    words."""
    scal, rows_i, rows_f, h, w = stress_queue(4, 0, dev)
    zk, sk = rq.raster_zslot_queue_cuda(scal, rows_i, rows_f, h, w)
    zp, sp = rq.raster_zslot_queue_plain(scal, rows_i, rows_f, h, w)
    torch.cuda.synchronize(dev)
    words = zslot_mismatches(zk, sk, zp, sp)
    print(f"B7 stress queue: {int((sp >= 0).sum())} covered px of "
          f"{tuple(sk.shape)}: {words} mismatching words", flush=True)
    return words


def time_bound(bytes_moved: float, ops: float, sfu_ops: float = 0.0,
               ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their rate, the FP32 one unless named (special-function
    operations over theirs)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / ops_per_s, sfu_ops / SFU_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def random_grid(shape, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, shape, generator=gen,
                         dtype=torch.int32).to(dev)


def b4_vs_plain(dev, gb) -> dict:
    """B4 against its plain version, bit for bit and its input unchanged,
    in B4_CASES: packed [8, 256] in both forms (the plan's resident one
    and tiled), [64, 2048] tiled (too large for the resident form) and
    [8, 1024], the resident form's widest grid."""
    out = {}
    for (r, c), k, form in B4_CASES:
        packed = gb.pack_rows(random_grid((r, c), r, dev))
        before = packed.clone()
        plan = gb._b4_plan(*packed.shape, k, form)
        calls = gb.multi_step_packed_cuda.launches
        got = gb.multi_step_packed_cuda(packed, k, form)
        calls = gb.multi_step_packed_cuda.launches - calls
        want = gb.multi_step_packed_plain(packed, k)
        torch.cuda.synchronize(dev)
        bad = int((got != want).sum())
        changed = int((packed != before).sum())
        words = packed.numel()
        bms, by = time_bound(2 * words * 4, words * k * OPS_SWAR,
                             ops_per_s=INT_LOGIC_OPS_PER_S)
        run = lambda: gb.multi_step_packed_cuda(packed, k, form)
        out[f"{r}x{c} {plan.form}"] = dict(
            err=float(bad), bad=bad + changed + int(calls != plan.launches),
            ms=device_ms(run, 10, "swar_kernel", plan.launches),
            call_ms=cuda_ms(run, 10),
            plain_ms=cuda_ms(lambda: gb.multi_step_packed_plain(packed, k), 1),
            bound_ms=bms, bound_by=by,
            work=f"packed {list(packed.shape)}, {k} generations, "
                 f"{plan.form}, {plan.launches} launches")
        print(f"B4 {r}x{c} (packed {list(packed.shape)}), {k} generations, "
              f"{plan.form} form, {calls} launches a call (planned "
              f"{plan.launches}): {bad} mismatching words, {changed} input "
              f"words changed", flush=True)
    return out


def b8_vs_plain(dev, gs) -> dict:
    """B8 against its plain version in B8_CASES, bit for bit, with the
    launches its plan gives; the plan printed per case."""
    out = {}
    for (r, c), k in B8_CASES:
        g = random_grid((r, c), r + 1, dev).to(torch.float32)
        plan = gs._b8_plan(r, c, k)
        calls = gs.multi_step_pallas_cuda.launches
        got = gs.multi_step_pallas_cuda(g, k)
        calls = gs.multi_step_pallas_cuda.launches - calls
        want = gs.multi_step_pallas_plain(g, k)
        torch.cuda.synchronize(dev)
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        # the f32 grid read and written once; 18 integer ops per 32 cells
        # and generation
        bms, by = time_bound(2 * g.numel() * 4, g.numel() / 32 * k * OPS_SWAR,
                             ops_per_s=INT_LOGIC_OPS_PER_S)
        run = lambda: gs.multi_step_pallas_cuda(g, k)
        work = (f"{r}x{c} f32, {k} generations, {plan.launches} launches "
                f"of {plan.blocks} one-warp blocks, {plan.halo} generations "
                f"a launch")
        out[f"{r}x{c} x{k}"] = dict(
            err=float((got - want).abs().max()),
            bad=bad + int(calls != plan.launches),
            ms=device_ms(run, 10, "stencil_kernel", plan.launches),
            call_ms=cuda_ms(run, 10),
            plain_ms=cuda_ms(lambda: gs.multi_step_pallas_plain(g, k), 2),
            bound_ms=bms, bound_by=by, work=work)
        print(f"B8 {work} (plan {plan}): {calls} launches a call (planned "
              f"{plan.launches}), {bad} mismatching words", flush=True)
    return out


def b6_parts(run, calls: int, reps: int) -> dict:
    """Device milliseconds per run() call of B6's launches by kind: count,
    scan, scatter (the passes before the last) and last scatter (the
    outputs' writes and gathers), from a session that kept all `calls`
    launches of each of its `reps` calls."""
    events = sorted(device_events(run, reps,
                                  lambda ev: len(ev) == calls * reps),
                    key=lambda e: e.time_range.start)
    parts, scatters = {}, 0
    for e in events:
        kind = next((k for k in ("count", "scan", "scatter")
                     if f"{k}_kernel" in e.name), e.name)
        if kind == "scatter":
            scatters += 1
            if scatters % (calls // 3) == 0:
                kind = "last scatter"
        parts[kind] = parts.get(kind, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / reps
    return parts


def b6_case(dev, case: str, n: int, bh, stable_orbits):
    """(key, idx or None, five payloads) of a B6 case on the card: the
    N-body's Morton codes of stable orbits carrying px, py, m, vx, vy; or
    keys from a seed (full-range signed with INT32_MIN, -1, 0 and
    INT32_MAX; constant; random) carrying four f32 and one int32 payload,
    with an explicit, permuted, partly negative idx for "idx"."""
    from rustexp_tpu_torch.core import prng

    gen = torch.Generator().manual_seed(n)
    if case == "morton":
        px, py, vx, vy, m = stable_orbits(prng.key(n), n, device=dev)
        key = bh.morton_codes(px, py, px.min(), px.max(), py.min(), py.max())
        return key, None, [px, py, m, vx, vy]
    lo, hi = -(1 << 31), (1 << 31) - 1
    if case == "constant":
        key = torch.zeros(n, dtype=torch.int32)
    else:
        key = torch.randint(lo if case == "signed" else 0, hi, (n,),
                            generator=gen, dtype=torch.int32)
    if case == "signed":
        key[:8] = torch.tensor([lo, -1, 0, hi] * 2, dtype=torch.int32)
        key = key[torch.randperm(n, generator=gen)]
    idx = None
    if case == "idx":
        key %= 7  # ties, broken by the idx
        idx = (torch.randperm(n, generator=gen).to(torch.int32)
               - n // 3).to(dev)
    vals = [torch.randn(n, generator=gen).to(dev) for _ in range(4)]
    vals.append(torch.randint(-9, 9, (n,), generator=gen,
                              dtype=torch.int32).to(dev))
    return key.to(dev), idx, vals


def b6_vs_plain(dev, sb, bh, stable_orbits) -> dict:
    """B6 against its plain version, bit for bit on keys, idx and the five
    payloads, with the inputs unchanged, in B6_CASES; timed on the N-body's
    Morton sort at n = 131,072 in the positions form, as morton_sort calls
    it, beside the library call (a stable torch.sort and 6 gathers), both
    by the card's whole activity per call, B6's by kind of launch too."""
    out = {}
    for case, n in B6_CASES:
        key, idx, vals = b6_case(dev, case, n, bh, stable_orbits)
        inputs = [key, *vals] + ([] if idx is None else [idx])
        before = [t.clone() for t in inputs]
        kk, ik, vk = sb.sort_kv_cuda(key, idx, vals)
        kp, ip, vp = sb.sort_kv_plain(key, idx, vals)
        torch.cuda.synchronize(dev)
        bad = int((kk != kp).sum()) + int((ik != ip).sum())
        bad += sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   for a, b in zip(vk, vp))
        changed = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                      for a, b in zip(inputs, before))
        distinct = int(torch.unique(key).numel())
        print(f"B6 {case} n={n}, {len(vals)} payloads, "
              f"{'explicit idx' if idx is not None else 'positions'}, "
              f"{distinct} distinct keys: {bad} mismatching words, "
              f"{changed} input words changed", flush=True)
        rec = dict(err=float(bad), bad=bad + changed,
                   work=f"{case}, n {n}, {len(vals)} payloads, {distinct} "
                        f"distinct keys")
        if case == "morton":
            def library(key=key, vals=vals):
                order = torch.sort(key, stable=True).indices
                return key[order], [v[order] for v in vals]

            run = lambda: sb.sort_kv_cuda(key, None, vals)
            calls = sb.sort_kv_cuda.launches
            run()
            calls = sb.sort_kv_cuda.launches - calls
            # the positions form reads the key and the payloads and writes
            # the key, idx and the payloads, each once
            rec["bound_ms"], rec["bound_by"] = time_bound(
                (1 + len(vals) + 2 + len(vals)) * n * 4, 0.0)
            # in turns: kernel, library, library, kernel
            p1 = b6_parts(run, calls, 20)
            l1 = device_ms(library, 20, None, None)
            l2 = device_ms(library, 20, None, None)
            p2 = b6_parts(run, calls, 20)
            parts = {k: (p1.get(k, 0.0) + p2.get(k, 0.0)) / 2
                     for k in {*p1, *p2}}
            rec.update(ms=sum(parts.values()), parts=parts,
                       library_ms=(l1 + l2) / 2, call_ms=cuda_ms(run, 20),
                       library_event_ms=cuda_ms(library, 20),
                       plain_ms=cuda_ms(
                           lambda: sb.sort_kv_plain(key, None, vals), 10))
        out[f"{case} {n}"] = rec
    return out


def force_errors(fk, fp) -> tuple:
    """(largest |dF| over the largest |F_plain|, the median per-particle
    |dF| / |F_plain|, largest absolute component error)."""
    (kx, ky), (px_, py_) = fk, fp
    diff = torch.hypot(kx - px_, ky - py_)
    mag = torch.hypot(px_, py_)
    return (float(diff.max() / mag.max()),
            float((diff / mag.clamp(min=1e-30)).median()),
            max(float((kx - px_).abs().max()), float((ky - py_).abs().max())))


def b5_vs_plain(dev, npl, stable_orbits) -> dict:
    """B5, both reciprocals, against its plain version at B5_NS (stable
    orbits), with the launches its plan gives."""
    from rustexp_tpu_torch.core import prng

    out = {}
    for n in B5_NS:
        px, py, _, _, m = stable_orbits(prng.key(2), n, device=dev)
        want = npl.forces_pallas_plain(px, py, m)
        splits, launches = npl._b5_plan(n)
        for approx in (False, True):
            calls = npl.forces_pallas_cuda.launches
            got = npl.forces_pallas_cuda(px, py, m, approx)
            calls = npl.forces_pallas_cuda.launches - calls
            torch.cuda.synchronize(dev)
            rel, med, err = force_errors(got, want)
            pairs = n * (n - 1)
            bms, by = time_bound(5 * n * 4, pairs * OPS_PAIR, sfu_ops=pairs)
            run = lambda: npl.forces_pallas_cuda(px, py, m, approx)
            reps = 3 if n > 20000 else 10
            out[(n, approx)] = dict(
                err=err, rel=rel, median_rel=med,
                bad=int(rel > B5_RTOL[approx]) + int(calls != launches),
                ms=device_ms(run, reps, None, launches),
                call_ms=cuda_ms(run, reps),
                plain_ms=cuda_ms(lambda: npl.forces_pallas_plain(px, py, m),
                                 1),
                bound_ms=bms, bound_by=by,
                work=f"N {n}, {'approximate' if approx else 'exact'} "
                     f"reciprocal, {splits} source splits, {launches} "
                     f"launches")
            print(f"B5 N={n} approx_recip={approx}: max |dF| / max |F| "
                  f"{rel:.3e} (tolerance {B5_RTOL[approx]:.0e}), median "
                  f"per-particle {med:.3e}, max abs error {err:.3e}; "
                  f"{splits} source splits, {calls} launches a call "
                  f"(planned {launches})", flush=True)
    return out


def gol_paths(dev, card, gol_exp, counters, launches, per_step: dict
              ) -> str | None:
    """The GoL Experiment at 256^2, auto (B4) then pallas (B8), 8
    generations per step, counted, each kernel launched `per_step[kernel]`
    times a step; the card's frames against the CPU's, bit for bit.
    Returns a failure message or None."""
    for backend, kernel in (("auto", "B4"), ("pallas", "B8")):
        frames = []
        for d in (dev, torch.device("cpu")):
            exp = gol_exp(d)
            st = exp.init(pattern="gun", steps_per_frame=8, backend=backend)
            for c in counters.values():
                c.launches = 0
            fb = []
            for _ in range(GOL_FRAMES):
                st = exp.step(st)
                fb.append(exp.render(st, 512, 512).cpu())
            if d.type == "cuda":
                got = {k: c.launches for k, c in counters.items()}
                print(f"launches during the GoL {backend} Experiment path: "
                      f"{got}; {exp.status(st)} [{card}]", flush=True)
                if got[kernel] == 0:
                    return f"the GoL {backend} path never launched {kernel}"
                if got[kernel] != GOL_FRAMES * per_step[kernel]:
                    return (f"the GoL {backend} path launched {kernel} "
                            f"{got[kernel]} times, not "
                            f"{GOL_FRAMES * per_step[kernel]}")
                for k in counters:
                    launches[k] += got[k]
            frames.append(torch.stack(fb))
        diff = int((frames[0] != frames[1]).sum())
        live = int((frames[0] == 0x00FFFFFF).sum())
        print(f"GoL {backend}: {GOL_FRAMES} frames, {live} live pixels, "
              f"{diff} px differ from the port's CPU frames", flush=True)
        if diff or live == 0:
            return f"GoL {backend}: {diff} px differ, {live} live"
    return None


def nbody_paths(dev, card, nb_exp, counters, launches, b5_per_step: int
                ) -> str | None:
    """The N-body Experiment on the card at N = 131,072 (theta 0.85: block
    BH, its Morton sort B6; theta 0: brute force, B5, `b5_per_step`
    launches a step) and N = 10,000 (BH, argsort), counted. Returns a
    failure message or None."""
    for n, theta, kernel in ((NBODY_N, 0.85, "B6"), (NBODY_N, 0.0, "B5"),
                             (10_000, 0.85, None)):
        exp = nb_exp(dev)
        st = exp.init(n=n, theta=theta)
        for c in counters.values():
            c.launches = 0
        for _ in range(NBODY_STEPS):
            st = exp.step(st)
        fb = exp.render(st, 512, 512)
        got = {k: c.launches for k, c in counters.items()}
        drawn = int((fb != 0).sum())
        finite = bool(torch.isfinite(torch.stack(
            [st.px, st.py, st.vx, st.vy])).all())
        print(f"launches during the N-body N={n} theta={theta} path: {got}; "
              f"{exp.status(st)}; {drawn} px drawn [{card}]", flush=True)
        if kernel is not None and got[kernel] == 0:
            return (f"the N-body N={n} theta={theta} path never launched "
                    f"{kernel}")
        if kernel == "B5" and got[kernel] != NBODY_STEPS * b5_per_step:
            return (f"the brute N-body path launched B5 {got[kernel]} "
                    f"times, not {NBODY_STEPS * b5_per_step}")
        if not finite or drawn < 1000:
            return f"N-body N={n}: finite={finite}, {drawn} px drawn"
        for k in counters:
            launches[k] += got[k]
    return None


def nbody_card_vs_cpu(dev, nb_exp) -> str | None:
    """A few steps from the same initial conditions on the card and on the
    CPU (BH with B6 at 4,096, brute B5 at 1,024, BH with argsort at
    10,000): frames within NBODY_FRAME_FRAC of pixels."""
    for n, theta in NBODY_CPU_CASES:
        frames, pos = [], []
        for d in (dev, torch.device("cpu")):
            exp = nb_exp(d)
            st = exp.init(n=n, theta=theta)
            for _ in range(NBODY_STEPS):
                st = exp.step(st)
            frames.append(exp.render(st, 256, 256).cpu())
            pos.append(torch.stack([st.px, st.py]).cpu())
        diff = int((frames[0] != frames[1]).sum())
        dpos = float((pos[0] - pos[1]).abs().max())
        print(f"N-body N={n} theta={theta}, {NBODY_STEPS} steps: {diff} px "
              f"differ from the port's CPU frame, max |dp| {dpos:.3e}",
              flush=True)
        if diff > NBODY_FRAME_FRAC * 256 * 256:
            return f"N-body N={n}: {diff} px differ from the CPU frame"
    return None


def _cells_word(row) -> int:
    """32 cells as a word, cell c at bit c."""
    return sum(int(v) << c for c, v in enumerate(row.tolist()))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 steps between two same-sign
    arrays (their bits as integers)."""
    ai = a.cpu().view(torch.int32).to(torch.int64)
    bi = b.cpu().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max())


def seeded_draws(dev) -> tuple[list[str], dict]:
    """The seeded states drawn on the card and on the CPU: the known
    answers above, and the card's GoL R grid at 2048^2, stable orbits at
    131,072 and the W key's disk of 10,000 equal to the CPU's word for
    word. -> (failures, {name: the card's draw as it is used})."""
    from rustexp_tpu_torch.core import prng
    from rustexp_tpu_torch.sims.gol import GoLExperiment
    from rustexp_tpu_torch.sims.nbody import NBodyExperiment, stable_orbits

    cpu, bad = torch.device("cpu"), []
    key0 = prng.key(0)
    if prng.split(key0).to(torch.int64).tolist() != [list(k)
                                                      for k in KAT_SPLIT]:
        bad.append("split(key(0)) differs from jax.random's")
    for (lo, hi), want in KAT_UNIFORM.items():
        u = prng.uniform(key0, (4,), lo, hi, dev)
        got = tuple(u.cpu().view(torch.int32).to(torch.int64).remainder(
            1 << 32).tolist())
        if got != want:
            bad.append(f"uniform({lo}, {hi}) on the card {got} != {want}")
    grids = []
    for d in (dev, cpu):
        exp = GoLExperiment(d)
        grids.append(exp.handle_key(exp.init(n=SEEDED_GOL_N), "R").grid)
    grid = grids[0]
    if not torch.equal(grid.cpu(), grids[1]):
        bad.append("the card's GoL R grid differs from the CPU's")
    g = grid.cpu()
    words = {rc: _cells_word(g[rc[0], rc[1]:rc[1] + 32])
             for rc in KAT_GOL_WORDS}
    if int(g.sum()) != KAT_GOL_LIVE or words != KAT_GOL_WORDS:
        bad.append(f"GoL R grid: {int(g.sum())} live, words {words}")
    orbits = [stable_orbits(key0, NBODY_N, device=d) for d in (dev, cpu)]
    if sum(_bits_differ(a.cpu(), b) for a, b in zip(*orbits)):
        bad.append("the card's stable orbits differ from the CPU's")
    at = torch.tensor(KAT_ORBITS_AT)
    for name, a in zip(("px", "py", "vx", "vy"), orbits[0]):
        want = torch.tensor(KAT_ORBITS[name], dtype=torch.int64).to(
            torch.int32).view(torch.float32)
        if _ulps(a.cpu()[at], want) > SEEDED_ULPS:
            bad.append(f"stable_orbits {name}: {a.cpu()[at].tolist()} "
                       f"against JAX's {want.tolist()}")
    disks = [NBodyExperiment(d).init(mode="disk", n=SEEDED_DISK_N)
             for d in (dev, cpu)]
    if sum(_bits_differ(a.cpu(), b) for a, b in zip(
            *((s.px, s.py, s.vx, s.vy, s.m) for s in disks))):
        bad.append("the card's W-key disk differs from the CPU's")
    return bad, {"grid": grid, "orbits": orbits[0]}


def seeded_kernels(dev, gb, sb, bh, npl, grid, orbits) -> dict:
    """B4, B5 and B6 on the seeded states against their plain versions on
    the card: B4 100 generations of the 2048^2 R grid, B6 the Morton sort
    of the stable orbits (positions form, five payloads), bit for bit;
    B5 their forces, both reciprocals, within B5_RTOL. -> {kernel: {label:
    {"err", "bad"}}}"""
    packed = gb.pack_rows(grid.to(torch.int32))
    got = gb.multi_step_packed_cuda(packed, 100)
    bad4 = int((got != gb.multi_step_packed_plain(packed, 100)).sum())
    px, py, vx, vy, m = orbits
    key = bh.morton_codes(px, py, px.min(), px.max(), py.min(), py.max())
    kk, ik, vk = sb.sort_kv_cuda(key, None, [px, py, m, vx, vy])
    kp, ip, vp = sb.sort_kv_plain(key, None, [px, py, m, vx, vy])
    bad6 = sum(_bits_differ(a, b)
               for a, b in zip((kk, ik, *vk), (kp, ip, *vp)))
    want = npl.forces_pallas_plain(px, py, m)
    out5 = {}
    for approx in (False, True):
        rel, _, err = force_errors(npl.forces_pallas_cuda(px, py, m, approx),
                                   want)
        out5[f"seeded {NBODY_N} approx={approx}"] = dict(
            err=err, rel=rel, bad=int(rel > B5_RTOL[approx]))
    return {"B4": {f"seeded R {SEEDED_GOL_N}^2 x100": dict(err=float(bad4),
                                                          bad=bad4)},
            "B6": {f"seeded morton {NBODY_N}": dict(err=float(bad6),
                                                    bad=bad6)},
            "B5": out5}


def seeded_states(dev, card, gb, sb, bh, npl, gol_exp, counters, launches
                  ) -> tuple[str | None, dict]:
    """The seeded-state phase: seeded_draws, the draws timed on the card
    (CUDA events) and on the CPU, seeded_kernels, and the GoL Experiment
    with backend "bits_banded" one step of SEEDED_GOL_GENS from the R grid,
    counted (B4, as its plan says), its grid against the CPU's. Which
    uint32 operations the card's torch has is printed: the draws compute
    in int64 because the CPU's has no add or shift for uint32.
    -> (a failure message or None, seeded_kernels' records)."""
    from rustexp_tpu_torch.core import prng
    from rustexp_tpu_torch.sims.gol import randomize
    from rustexp_tpu_torch.sims.nbody import stable_orbits

    have = {}
    for op, fn in (("make", lambda a: a), ("add", lambda a: a + a),
                   ("shift", lambda a: a >> 3), ("xor", lambda a: a ^ a),
                   ("less", lambda a: a < a)):
        try:
            fn(torch.tensor([0xFFFFFFF0, 5], device=dev).to(torch.uint32))
            have[op] = True
        except (RuntimeError, NotImplementedError):
            have[op] = False
    print(f"torch.uint32 on the card (torch {torch.__version__}): {have}",
          flush=True)
    bad, drawn = seeded_draws(dev)
    for msg in bad:
        print(f"seeded: {msg}", flush=True)
    if bad:
        return f"seeded states: {bad[0]}", {}
    print(f"seeded states: split, uniform and the GoL grid equal JAX's known "
          f"answers, stable orbits within {SEEDED_ULPS} ulps of them; the "
          f"card's GoL R grid {SEEDED_GOL_N}^2, stable orbits {NBODY_N} "
          f"and disk {SEEDED_DISK_N} equal the CPU's word for word",
          flush=True)
    sub = prng.split(prng.key(0))[1]
    for label, run in (
            (f"GoL R {SEEDED_GOL_N}^2",
             lambda d: randomize(sub, SEEDED_GOL_N, d)),
            (f"stable_orbits {NBODY_N}",
             lambda d: stable_orbits(sub, NBODY_N, device=d))):
        ms = cuda_ms(lambda: run(dev), 5)
        t0 = time.perf_counter()
        run("cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        print(f"time seeded draw {label}: card {ms:.4f} ms (CUDA events), "
              f"CPU {cpu_ms:.1f} ms (host clock, one call) [{card}]",
              flush=True)
    rec = seeded_kernels(dev, gb, sb, bh, npl, drawn["grid"],
                         drawn["orbits"])
    for kernel, cmp in rec.items():
        for label, r in cmp.items():
            print(f"{kernel} {label}: error {r['err']:.3e}, bad {r['bad']}",
                  flush=True)
            if r["bad"]:
                return (f"{kernel} {label} disagrees with its plain version "
                        f"on the seeded state"), rec
    grids = []
    expect = gb._b4_plan(SEEDED_GOL_N // 32, SEEDED_GOL_N,
                         SEEDED_GOL_GENS).launches
    for d in (dev, torch.device("cpu")):
        exp = gol_exp(d)
        st = exp.handle_key(exp.init(n=SEEDED_GOL_N, backend="bits_banded",
                                     steps_per_frame=SEEDED_GOL_GENS), "R")
        for c in counters.values():
            c.launches = 0
        st = exp.step(st)
        if d.type == "cuda":
            got = {k: c.launches for k, c in counters.items()}
            print(f"launches during the GoL bits_banded Experiment path "
                  f"(seeded R grid {SEEDED_GOL_N}^2): {got}; "
                  f"{exp.status(st)} [{card}]", flush=True)
            if got["B4"] != expect:
                return (f"the GoL bits_banded path launched B4 {got['B4']} "
                        f"times, not {expect}"), rec
            for k in counters:
                launches[k] += got[k]
        grids.append(st.grid.cpu())
    if not torch.equal(grids[0], grids[1]):
        return "the bits_banded grid differs from the CPU's", rec
    return None, rec


def gbuffer_paths(dev, card, pp, shard, meshes, cubemap, camera, exp_cls,
                  counters, launches):
    """The G-buffer and deferred paths on KillerooP at 512x512, TICKS, each
    counted on its own: render_frame_sharded(group=None, backend="pallas")
    and four 128-row bands one after another (B3), render_frame(
    backend="xla") and the Experiment at a 500x500 window (no kernel),
    raster_and_shade_queue(defer=True) P and V (B7). The xla, pallas (B2)
    and band (B3) frames must equal each other and defer the planes
    frames (B1) at 0 px, and card frames the port's CPU frames within
    GOLDEN_FRAC.
    Returns (failure message or None, [(label, frame fn, kernel name)] for
    the profiles)."""
    cpu = torch.device("cpu")
    scenes = {d: pp.make_scene(meshes.get_mesh(0), cubemap.get_cm_set(0), d)
              for d in (dev, cpu)}
    eyes = {t: camera.camera_eye(meshes.mesh_camera(0), t) for t in TICKS}
    kw = dict(w=W, h=H, per_pixel=True, shader_idx=5)

    def counted(label, fn, kernel):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize(dev)
        got = {k: c.launches for k, c in counters.items()}
        print(f"launches during {label}: {got} [{card}]", flush=True)
        if kernel is None and any(got.values()):
            raise RuntimeError(f"{label} launched a kernel: {got}")
        if kernel is not None and got[kernel] == 0:
            raise RuntimeError(f"{label} never launched kernel {kernel}")
        msg = shade_per_render(label, got)
        if msg:
            raise RuntimeError(msg)
        for k in counters:
            launches[k] += got[k]
        return out

    def sharded(d, t):
        return shard.render_frame_sharded(scenes[d], eyes[t], t, None,
                                          backend="pallas", **kw)

    def bands(d, t):
        return torch.cat([shard.render_band(
            scenes[d], eyes[t], t, band=b, n_bands=4, backend="pallas",
            **kw)[0] for b in range(4)]).view(torch.uint32)

    def oracle(d, t, backend="xla"):
        return pp.render_frame(scenes[d], eyes[t], t, backend=backend,
                               show_cm=False, **kw)

    got = {"band path": counted(
               "render_frame_sharded(group=None, backend='pallas')",
               lambda: [sharded(dev, t) for t in TICKS], "B3"),
           "4 bands": counted("4 bands one after another",
                              lambda: [bands(dev, t) for t in TICKS], "B3"),
           "xla": counted("render_frame(backend='xla')",
                          lambda: [oracle(dev, t) for t in TICKS], None)}
    empty = pp.background(0, W, H, "cpu")
    for i, t in enumerate(TICKS):
        ref = got["xla"][i].cpu().view(torch.int32)
        cpu_ref = oracle(cpu, t).view(torch.int32)
        drawn = int((ref != empty).sum())
        diffs = {k: int((v[i].cpu().view(torch.int32) != ref).sum())
                 for k, v in got.items()}
        diffs["pallas (B2)"] = int(
            (oracle(dev, t, "pallas").cpu().view(torch.int32) != ref).sum())
        diffs["xla CPU"] = int((ref != cpu_ref).sum())
        if i == 0:
            diffs["band path CPU (plain B3)"] = int(
                (sharded(cpu, t).view(torch.int32) != cpu_ref).sum())
        print(f"G-buffer frames KillerooP tick {t}: {drawn} px drawn; px "
              f"differing from the card's xla frame: {diffs}", flush=True)
        if drawn < W * H // 100 or any(
                v for k, v in diffs.items() if "CPU" not in k):
            return f"G-buffer frames tick {t}: {drawn} drawn, {diffs}", []
        if max(v for k, v in diffs.items() if "CPU" in k) > GOLDEN_FRAC * W * H:
            return f"G-buffer frames tick {t}: {diffs} vs the CPU", []

    exp, cpu_exp = exp_cls(dev), exp_cls(cpu)
    st, cpu_st = exp.init(per_pixel=True), cpu_exp.init(per_pixel=True)
    n = UNTILEABLE
    frames = counted(f"the Experiment at {n}x{n}",
                     lambda: [exp.render(st, n, n, t) for t in TICKS], None)
    bg = pp.background(0, n, n, "cpu")
    for t, fb in zip(TICKS, frames):
        ref = cpu_exp.render(cpu_st, n, n, t).view(torch.int32)
        gpu = fb.cpu().view(torch.int32)
        drawn, diff = int((gpu != bg).sum()), int((gpu != ref).sum())
        print(f"Experiment KillerooP {n}x{n} tick {t} ({exp.status(st)}): "
              f"{drawn} px drawn, {diff} px differ from the port's CPU "
              f"frame [{card}]", flush=True)
        if fb.shape != (n, n) or fb.dtype != torch.uint32 or (
                drawn < n * n // 100 or diff > GOLDEN_FRAC * n * n):
            return f"Experiment {n}x{n} tick {t}: {drawn} drawn, {diff}", []

    profiles = [
        (f"KillerooP {W}x{H} xla (oracle)", lambda: oracle(dev, 0.0), None),
        (f"KillerooP {W}x{H} band path (B3, 1 band)",
         lambda: sharded(dev, 0.0), "bins_gbuffer_kernel"),
        (f"KillerooP {W}x{H} 4 bands (B3)", lambda: bands(dev, 0.0),
         "bins_gbuffer_kernel"),
        (f"KillerooP {n}x{n} Experiment (oracle)",
         lambda: exp.render(st, n, n, 0.0), None)]
    for per_pixel in (True, False):
        tag = "P" if per_pixel else "V"
        queues = {(d, t): pp.build_scene_queue(scenes[d], eyes[t], W, H,
                                               per_pixel=per_pixel)
                  for d in (dev, cpu) for t in TICKS if d == dev or t == 0}

        def queue_frame(d, t, defer, per_pixel=per_pixel, queues=queues):
            colors = None if per_pixel else pp.vertex_colors(
                scenes[d], eyes[t], t, W, H, 5)
            return pp.raster_and_shade_queue(
                scenes[d], queues[(d, t)], colors, eyes[t], t, w=W, h=H,
                per_pixel=per_pixel, shader_idx=5,
                bg_fb=pp.background(0, W, H, d), defer=defer)

        deferred = counted(f"raster_and_shade_queue(defer=True) Killeroo{tag}",
                           lambda: [queue_frame(dev, t, True)
                                    for t in TICKS], "B7")
        for t, (fb, stale) in zip(TICKS, deferred):
            planes, _ = queue_frame(dev, t, False)
            diff = int((fb != planes).sum())
            cpu_diff = -1
            if t == TICKS[0]:
                cpu_diff = int((fb.cpu() != queue_frame(cpu, t, True)[0])
                               .sum())
            drawn = int((fb.cpu() != empty).sum())
            print(f"deferred Killeroo{tag} tick {t}: {drawn} px drawn, "
                  f"stale {bool(stale)}, {diff} px differ from the planes "
                  f"frame (B1), {cpu_diff} from the port's CPU deferred "
                  f"frame (-1: not compared) [{card}]", flush=True)
            if (diff or bool(stale) or drawn < W * H // 100
                    or cpu_diff > GOLDEN_FRAC * W * H):
                return (f"deferred Killeroo{tag} tick {t}: {diff} px vs "
                        f"planes, {cpu_diff} vs CPU, {drawn} drawn"), []
        profiles += [
            (f"Killeroo{tag} {W}x{H} deferred (B7)",
             lambda f=queue_frame: f(dev, 0.0, True), "queue_raster_kernel"),
            (f"Killeroo{tag} {W}x{H} planes (B1)",
             lambda f=queue_frame: f(dev, 0.0, False), "queue_raster_kernel")]
    return None, profiles


def path_profiles(profiles) -> list[dict]:
    """Per G-buffer or deferred path: wall ms per frame (CUDA events around
    PATH_FRAMES back-to-back frames, host time included), device-busy ms,
    device activities and kernel ms per frame (torch.profiler), and the
    idle share 1 - busy / wall."""
    out = []
    for label, fn, kernel in profiles:
        wall = cuda_ms(fn, PATH_FRAMES)
        events = device_events(fn, PATH_FRAMES)
        busy = busy_ms(events) / PATH_FRAMES
        k_ms = sum(e.time_range.end - e.time_range.start for e in events
                   if kernel and kernel in e.name) / 1e3 / PATH_FRAMES
        out.append(dict(label=label, wall_ms=wall, busy_ms=busy,
                        idle=1.0 - busy / wall,
                        activities=len(events) / PATH_FRAMES,
                        kernel_ms=k_ms))
    return out


def bench_profiles(dev, records, gb, bh, npl, stable_orbits) -> list[dict]:
    """Per GoL and N-body bench record, where its time goes on the card:
    device-busy ms and device activities per generation or step, by the
    profiler (GoL: a call of 4,096 generations; N-body: one step), and the
    idle share against the record's unprofiled median."""
    from rustexp_tpu_torch.core import prng

    out = []
    for label, rec in records:
        if rec["metric"] == "gol_cell_updates_per_s":
            g = random_grid((rec["n"], rec["n"]), 0, dev)
            fn = lambda g=g: gb.multi_step_swar(g, 4096)
            units, unit = 4096, "generation"
            wall = rec["n"] ** 2 / rec["value_median"]
        else:
            st = stable_orbits(prng.key(0), rec["n"], device=dev)
            if rec["route"] == "bh":
                fn = lambda st=st, k=rec["k_near"]: bh.step_bh(*st, 256, k)
            else:
                fn = lambda st=st: npl.step_brute_pallas(*st, 1024, True)
            units, unit, wall = 1, "step", 1.0 / rec["value_median"]
        events = device_events(fn, 2)
        busy = busy_ms(events) / 2 / units
        out.append(dict(label=label, unit=unit, busy_ms=busy,
                        wall_ms=wall * 1e3, idle=1.0 - busy / (wall * 1e3),
                        activities=len(events) / 2 / units))
    return out


# The moving camera (app/benchmark.py bench_scene_moving): every frame
# rebuilds the queue with build_queue's "auto" order at caps from a
# pre-pass over the mesh's camera path, so B1 and B7 meet the plane and
# direct layouts there. (label, mesh, the order "auto" resolves)
MOVING_SCENES = (("KillerooP", 0, "plane"), ("TorusKnotP", 6, "plane"),
                 ("CubeP", 9, "direct"))
MOVING_K = 64  # frames of the camera path a pass (ticks i / 60)
MOVING_RUNS = 3  # timed passes, after a warm-up pass
MOVING_EYE = 21  # the path eye of the kernel checks and the profiles
MOVING_CPU_EYES = (0, 21, 42, 63)  # path eyes held against the CPU
AMORTIZED_EVERY = 4  # frames per queue in the amortized form
# B1's three forms: (label, per_pixel, ray_world) -> (4, 0), (4, 3), (4, 6)
B1_FORMS = (("V", False, True), ("P", True, True),
            ("P ray_world=False", True, False))
SHADER_FRAGMENTS = 1 << 16  # seeded fragments per shader, card vs CPU


def short_batches(bench, mesh_idx: int, per_pixel: bool, dev) -> dict:
    """bench_scene's frame (scene_frame, "auto") timed in SHORT_RUNS runs
    of SHORT_FRAMES back-to-back frames after a one-frame warm-up, each run
    between two CUDA events, with no checksum -> _run_stats' record."""
    frame, _, _, _ = bench.scene_frame(mesh_idx, per_pixel, dev)
    stale_any = torch.zeros((), dtype=torch.bool, device=dev)

    def frames() -> None:
        nonlocal stale_any
        for _ in range(SHORT_FRAMES):
            stale_any = stale_any | frame()[1]

    frame()
    torch.cuda.synchronize(dev)
    st = bench._run_stats(lambda: bench._event_seconds(frames), SHORT_RUNS,
                          SHORT_FRAMES)
    if bool(stale_any):
        raise RuntimeError("short batches: the cached structure went stale")
    return st


def _stats_text(st: dict) -> str:
    return (f"best {st['best'] * 1e3:.4f} ms, median "
            f"{st['median'] * 1e3:.4f} ms, spread {st['spread_pct']:.1f}% "
            f"over {st['n_runs']} runs")


def sampling(dev, card, bench, counters, launches
             ) -> tuple[str | None, dict]:
    """run_suite in this process at bench.py's runs (BENCH_SCENE_RUNS:
    bench_scene's 1,024-frame warm-up, then 2 timed runs of 1,024 frames,
    each frame with its checksum) over bench.SCENES cut to SAMPLING_SCENES,
    one scene of each raster kernel, for the time limit (the fresh bench
    of surfaces() times all 12); before it, short batches of the same
    frames (short_batches) on each. Launches are counted on their own for
    each scene's short batches and for run_suite: the scene's raster
    kernel (B1 on the queue, B2 on the bins) once a frame, and no other
    kernel. Each row's checksum must equal that of the same frame rendered
    on the CPU. Returns a failure message or None, and {scene: {"short":
    stats, "bench_scene": run_suite's row}}.
    """
    k = bench.FRAMES_PER_DISPATCH
    timed = max(1, BENCH_SCENE_RUNS // 8)
    cpu = torch.device("cpu")
    cut = tuple(s for s in bench.SCENES if s[0] in SAMPLING_SCENES)
    shorts = {}
    for label, mesh_idx, per_pixel, _ in cut:
        _zero(counters)
        shorts[label] = (short_batches(bench, mesh_idx, per_pixel, dev),
                         _launches(counters))
    _zero(counters)
    full, bench.SCENES = bench.SCENES, cut
    try:
        suite = bench.run_suite(BENCH_SCENE_RUNS, verbose=False, device=dev)
    finally:
        bench.SCENES = full
    got = _launches(counters)
    print(f"launches during run_suite ({', '.join(SAMPLING_SCENES)}): "
          f"{_nonzero(got)}", flush=True)
    for c in counters:
        launches[c] += got[c] + sum(g[c] for _, g in shorts.values())
    kernel = {r["scene"]: "B1" if r["backend"] == "queue" else "B2"
              for r in suite["rows"]}
    for want_k in ("B1", "B2"):
        if got[want_k] == 0:
            return f"run_suite never launched kernel {want_k}", {}
    want = {}
    for r in suite["rows"]:
        for c in (kernel[r["scene"]], "S"):
            want[c] = want.get(c, 0) + (1 + timed) * k
    if _nonzero(got) != want or len(suite["scene_us"]) != len(cut):
        return (f"run_suite launched {_nonzero(got)} over "
                f"{len(suite['scene_us'])} scenes, want {want} over "
                f"{len(cut)}"), {}
    out = {}
    for r, (label, mesh_idx, per_pixel, _) in zip(suite["rows"], cut):
        short, got_short = shorts[label]
        fb, stale = bench.scene_frame(mesh_idx, per_pixel, cpu)[0]()
        want_sum = int(bench.wrap32(bench.frame_sum(fb, stale)))
        print(f"sampling {label} 512x512 ({r['backend']}), short batches "
              f"({SHORT_RUNS} runs x {SHORT_FRAMES} frames, a one-frame "
              f"warm-up, CUDA events): {_stats_text(short)}; launches "
              f"{_nonzero(got_short)} [{card}]", flush=True)
        print(f"sampling {label} 512x512 ({r['backend']}), run_suite's "
              f"bench_scene (JAX's: {r['n_runs']} runs x "
              f"{r['frames_per_run']} frames, a {k}-frame warm-up, CUDA "
              f"events): {_stats_text(r)}; checksum {r['checksum']:#010x} "
              f"(the CPU frame's {want_sum:#010x}) [{card}]", flush=True)
        want_short = {kernel[label]: 1 + SHORT_RUNS * SHORT_FRAMES,
                      "S": 1 + SHORT_RUNS * SHORT_FRAMES}
        if (r["scene"] != label or _nonzero(got_short) != want_short
                or (r["n_runs"], r["frames_per_run"]) != (timed, k)):
            return (f"sampling {label}: run_suite's row {r['scene']} in "
                    f"{r['n_runs']} runs x {r['frames_per_run']} frames, "
                    f"short batches launched {got_short} (want "
                    f"{want_short})"), out
        if r["checksum"] != want_sum:
            return (f"sampling {label}: checksum {r['checksum']:#010x} on "
                    f"the card, {want_sum:#010x} on the CPU"), out
        out[label] = {"short": short, "bench_scene": r}
    return None, out


def moving_scene(dev, pp, bench, meshes, cubemap, mesh_idx: int):
    """(scene, path eyes, caps) of a moving scene on `dev`: MOVING_K host
    eyes of the mesh's camera path and moving_caps' per-pixel caps, as
    bench_scene_moving takes them."""
    scene = pp.make_scene(meshes.get_mesh(mesh_idx), cubemap.get_cm_set(0),
                          dev)
    eyes = bench.path_eyes(mesh_idx, MOVING_K)
    return scene, eyes, bench.moving_caps(scene, eyes, True)


def moving_queue_args(pp, rq, scene, eye, caps: dict, order: str,
                      per_pixel: bool, ray_world: bool = True):
    """(queue, B1's arguments) of one moving frame: the queue build_queue
    makes at `caps` in `order`, and queue_args on it."""
    queue = rq.build_queue(pp._queue_setup(scene, eye, W, H), H, W,
                           **{**caps, "order": order})
    return queue, queue_args(pp, rq, scene, queue, eye, per_pixel, ray_world)


def kernels_on_orders(dev, card, pp, rq, bench, meshes, cubemap):
    """B1 in its three forms on the plane queues of KillerooP and
    TorusKnotP and the direct queue of CubeP at path eye MOVING_EYE, 0
    mismatching words each; B1 timed on the plane and the tri queue of
    one frame in turns; B7 on KillerooP's plane queue, z and slot on
    every word; and KillerooP's deferred frame on that queue against its
    planes frame, 0 px. Returns (failure message or None, {label: B1
    record}, {label: B7 record}) with the P forms' timed records."""
    cmp1, cmp7 = {}, {}
    for label, mesh_idx, expect in MOVING_SCENES:
        scene, eyes, caps = moving_scene(dev, pp, bench, meshes, cubemap,
                                         mesh_idx)
        eye = eyes[MOVING_EYE]
        for form, per_pixel, ray_world in B1_FORMS:
            queue, args = moving_queue_args(pp, rq, scene, eye, caps, "auto",
                                            per_pixel, ray_world)
            tag = (f"{label[:-1]}{form} {queue.order} queue (moving eye "
                   f"{MOVING_EYE}, caps {caps})")
            if queue.order != expect:
                return f"{tag}: 'auto' resolved {queue.order}", {}, {}
            r = b1_check(dev, rq, tag, args, timed=form == "P")
            if r["bad"] or r["covered"] == 0:
                return (f"B1 {tag}: {r['bad']} mismatching words, "
                        f"{r['covered']} covered px"), {}, {}
            if form == "P":
                cmp1[f"{label} {expect} (moving)"] = r
        if expect != "plane":
            continue
        runs = {order: moving_queue_args(pp, rq, scene, eye, caps, order,
                                         True)[1]
                for order in ("plane", "tri")}
        turns = [(order, device_ms(
                     lambda a=runs[order]: rq.raster_attrs_queue_cuda(*a),
                     50, None, 1))
                 for order in ("plane", "tri", "tri", "plane")]
        print(f"time B1 {label} 512x512 at moving eye {MOVING_EYE}, the "
              f"plane and the tri queue of one frame in turns (all the "
              f"call's activity, profiler): "
              + ", ".join(f"{o} {ms:.4f}" for o, ms in turns)
              + f" ms [{card}]", flush=True)

    scene, eyes, caps = moving_scene(dev, pp, bench, meshes, cubemap, 0)
    eye = eyes[MOVING_EYE]
    queue, args = moving_queue_args(pp, rq, scene, eye, caps, "auto", True)
    tag = f"KillerooP {queue.order} queue (moving eye {MOVING_EYE})"
    r = b7_check(dev, rq, tag, args[:3] + args[5:])
    if r["bad"] or r["covered"] == 0:
        return (f"B7 {tag}: {r['bad']} mismatching words, {r['covered']} "
                f"covered px"), {}, {}
    cmp7[f"KillerooP {queue.order} (moving)"] = r
    bg = pp.background(0, W, H, dev)
    fbs = [pp.raster_and_shade_queue(scene, queue, None, eye, 0.0, w=W, h=H,
                                     per_pixel=True, shader_idx=5, bg_fb=bg,
                                     defer=defer)[0]
           for defer in (True, False)]
    diff = int((fbs[0] != fbs[1]).sum())
    print(f"deferred KillerooP frame on the {queue.order} queue (B7): "
          f"{diff} px differ from the planes frame (B1) [{card}]",
          flush=True)
    if diff:
        return f"deferred {tag}: {diff} px differ from the planes frame", \
            {}, {}
    return None, cmp1, cmp7


def moving_paths(dev, card, pp, rq, bench, meshes, cubemap, counters,
                 launches) -> str | None:
    """The moving camera's main path, each bench counted on its own:
    bench_scene_moving on MOVING_SCENES and bench_scene_moving_amortized
    on KillerooP, k = MOVING_K, MOVING_RUNS timed passes after a warm-up
    pass; each must resolve its order and launch B1 once a frame rendered
    and no other kernel. Then card frames at MOVING_CPU_EYES against the
    port's CPU frames, the plane queue's frame against the tri queue's of
    the same eye (both 0 px), and one profiled moving frame per scene.
    Returns a failure message or None."""
    frames = (1 + MOVING_RUNS) * MOVING_K
    print(f"moving camera at 512x512: k = {MOVING_K} frames a pass, "
          f"{MOVING_RUNS} timed passes after a warm-up pass, {frames} "
          f"frames rendered a bench [{card}]", flush=True)
    runs = [(label, expect, lambda m=mesh_idx: bench.bench_scene_moving(
                m, True, MOVING_RUNS, k=MOVING_K, device=dev))
            for label, mesh_idx, expect in MOVING_SCENES]
    runs.append(("KillerooP amortized", "plane",
                 lambda: bench.bench_scene_moving_amortized(
                     0, True, MOVING_RUNS, k=MOVING_K,
                     rebuild_every=AMORTIZED_EVERY, device=dev)))
    records = {}
    for label, expect, run in runs:
        for c in counters.values():
            c.launches = 0
        rec = run()
        got = {k: c.launches for k, c in counters.items()}
        for k in counters:
            launches[k] += got[k]
        print(f"bench moving {label} {json.dumps(rec)} [{card}]", flush=True)
        print(f"moving {label}: order {rec['queue_order']}, caps s_cap "
              f"{rec['s_cap']} m_y {rec['m_y']} m_x {rec['m_x']} t_cap "
              f"{rec['t_cap']} shade_w {rec['shade_w']}; best "
              f"{rec['value']:.1f} us/frame, median {rec['us_median']:.1f} "
              f"us/frame (CUDA events); launches {got} ({frames} frames "
              f"rendered) [{card}]", flush=True)
        if rec["queue_order"] != expect:
            return f"moving {label} resolved {rec['queue_order']}"
        if got["B1"] != frames or got["S"] != frames or sum(
                got.values()) != 2 * frames:
            return f"moving {label} launched {got} for {frames} frames"
        records[label] = rec

    cpu = torch.device("cpu")
    empty = pp.background(0, W, H, "cpu")
    for label, mesh_idx, expect in MOVING_SCENES:
        scene, eyes, caps = moving_scene(dev, pp, bench, meshes, cubemap,
                                         mesh_idx)
        scene_c = pp.make_scene(meshes.get_mesh(mesh_idx),
                                cubemap.get_cm_set(0), cpu)
        for i in MOVING_CPU_EYES:
            fb, ov = bench.moving_frame(scene, eyes[i], caps, True)
            ref, ov_c = bench.moving_frame(scene_c, eyes[i], caps, True)
            gpu = fb.cpu().view(torch.int32)
            drawn = int((gpu != empty).sum())
            diff = int((gpu != ref.view(torch.int32)).sum())
            print(f"moving {label} eye {i}: {drawn} px drawn, overflow "
                  f"{bool(ov)}/{bool(ov_c)}, {diff} px differ from the "
                  f"port's CPU frame [{card}]", flush=True)
            if diff or bool(ov) or bool(ov_c) or drawn < W * H // 100:
                return f"moving {label} eye {i}: {diff} px vs the CPU"
        eye = eyes[MOVING_EYE]
        if expect == "plane":
            tri = rq.build_queue(pp._queue_setup(scene, eye, W, H), H, W,
                                 **{**caps, "order": "tri"})
            fb_tri = pp.render_frame(
                scene, eye, bench.TICK, w=W, h=H, per_pixel=True,
                shader_idx=bench.SHADER, bg_idx=0, show_cm=False,
                backend="queue", raster_queue=tri)
            diff = int((bench.moving_frame(scene, eye, caps, True)[0]
                        != fb_tri).sum())
            print(f"moving {label} eye {MOVING_EYE}: the plane queue's frame "
                  f"differs from the tri queue's by {diff} px [{card}]",
                  flush=True)
            if diff:
                return f"moving {label}: plane and tri frames differ"
        fn = lambda: bench.moving_frame(scene, eye, caps, True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            fn()
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in caught)
        events = device_events(fn, PROFILE_FRAMES)
        busy = busy_ms(events) / PROFILE_FRAMES
        b1 = sum(e.time_range.end - e.time_range.start for e in events
                 if "queue_raster_kernel" in e.name) / 1e3 / PROFILE_FRAMES
        wall = records[label]["us_median"] / 1e3
        print(f"profile moving {label} 512x512 eye {MOVING_EYE} "
              f"({PROFILE_FRAMES} frames): device busy {busy:.4f} ms/frame "
              f"(profiler, union of the card's activities), "
              f"{len(events) / PROFILE_FRAMES:.1f} device activities/frame, "
              f"B1 {b1:.4f} ms/frame; idle share "
              f"{(1.0 - busy / wall) * 100:.1f}% of the bench median "
              f"{wall:.4f} ms/frame; {syncs} synchronizing calls in a "
              f"frame (torch.cuda sync debug mode) [{card}]", flush=True)
    return None


def shader_configs(dev, card, pp, sh, meshes, cubemap, camera) -> str | None:
    """The 16 shaders on the card against the CPU: each function on
    SHADER_FRAGMENTS seeded fragments (words that differ, printed), and
    all 32 shader x mode frames of the Killeroo stand-in at 512x512
    through the queue route (differing px, printed; the run fails above
    GOLDEN_FRAC). Returns a failure message or None."""
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    n = SHADER_FRAGMENTS
    frag = (torch.rand((n, 3), generator=g) * 1.2 - 0.6,
            torch.randn((n, 3), generator=g),
            torch.rand((n, 3), generator=g),
            torch.tensor([0.3, 0.25, 1.7]))
    cm = torch.from_numpy(cubemap.get_cm_set(0).data)
    words = {}
    for i in range(sh.NUM_SHADERS):
        got = sh.shader_fn(i)(*(t.to(dev) for t in frag), 0.0, cm.to(dev))
        want = sh.shader_fn(i)(*frag, 0.0, cm)
        words[sh.shader_name(i)] = int(
            (got.cpu().view(torch.int32) != want.view(torch.int32)).sum())
    print(f"shader functions on {n} seeded fragments, words differing "
          f"between the card and the CPU: {words} [{card}]", flush=True)
    scenes = {d: pp.make_scene(meshes.get_mesh(0), cubemap.get_cm_set(0), d)
              for d in (dev, cpu)}
    eye = camera.camera_eye(meshes.mesh_camera(0), 0.0)
    worst = 0
    for per_pixel in (False, True):
        queues = {d: pp.build_scene_queue(scenes[d], eye, W, H,
                                          per_pixel=per_pixel)
                  for d in scenes}
        diffs = {}
        for i in range(sh.NUM_SHADERS):
            fbs = {d: pp.render_frame(
                       scenes[d], eye, 0.0, w=W, h=H, per_pixel=per_pixel,
                       shader_idx=i, backend="queue",
                       raster_queue=queues[d]).cpu().view(torch.int32)
                   for d in scenes}
            drawn = int((fbs[cpu] != pp.background(0, W, H, cpu)).sum())
            if drawn < W * H // 100:
                return f"shader {i} {per_pixel}: frame is background"
            diffs[sh.shader_name(i)] = int((fbs[dev] != fbs[cpu]).sum())
        worst = max(worst, *diffs.values())
        print(f"shader frames Killeroo{'P' if per_pixel else 'V'} 512x512 "
              f"(queue route, tick 0), px differing between the card and "
              f"the CPU: {diffs} [{card}]", flush=True)
    if worst > GOLDEN_FRAC * W * H:
        return f"a shader frame differs from the CPU's by {worst} px"
    return None


# The app shell: the CLI (rustexp_tpu_torch.app.cli.main), the turntable
# (--animate) and the viewer (app.viewer.run_viewer), as a user calls them.
APP_FRAMES = 8           # rasterizer and N-body frames a CLI run
APP_MODE_FRAMES = 2      # point and line frames a run, card and CPU
APP_BINS_FRAMES = 4      # the Cube (W keys) and KillerooP (P) runs
APP_GOL_FRAMES = 16      # a GoL run, then as many again after a load
APP_TURNTABLE = 64       # --animate frames (KillerooP)
APP_SINE_FRAMES = 4
APP_VIEWER_FRAMES = 8
APP_VIEWER_SIZE = 128
# An N-body state of a power-of-two N, saved and resumed through the CLI:
# its Morton sort takes B6. The CLI's own N = 10,000 sorts by argsort,
# as the JAX package's morton_sort does at any N that is not a power of
# two, so at the defaults no kernel launches.
APP_NBODY_LOADED = 16384
APP_MODE_KEYS = (("Killeroo points", "M"), ("Killeroo lines", "MM"),
                 ("TorusKnot points", "WWWWWWM"),
                 ("TorusKnot lines", "WWWWWWMM"))


class _StaleCount:
    """Counts the rasterizer Experiment's stale-structure rebuilds: each
    renders its frame a second time, and so launches its kernel again. The
    Experiment traces each one (core.trace, INFO); this sets the trace to
    INFO with a file sink at `path` and counts the sink's stale lines since
    the last reset(). close() puts the trace back to its defaults."""

    def __init__(self, path: str):
        from rustexp_tpu_torch.core import trace

        self._trace, self._path, self._base = trace, path, 0
        trace.setup(trace.TraceLevel.INFO, file_path=path, echo=False)

    def _lines(self) -> int:
        with open(self._path) as f:
            return sum("structure stale" in line for line in f)

    @property
    def n(self) -> int:
        return self._lines() - self._base

    def reset(self) -> None:
        self._base = self._lines()

    def close(self) -> None:
        self._trace.setup(self._trace.TraceLevel.WARN, file_path=None)


def _launches(counters) -> dict:
    return {k: c.launches for k, c in counters.items()}


def _nonzero(got: dict) -> dict:
    return {k: v for k, v in got.items() if v}


def shade_per_render(label: str, got: dict) -> str | None:
    """A failure message unless the shade kernel (S) launched once for
    each raster render of a counted path: each queue, bins or deferred
    frame (B1, B2 or B7) shades once; the G-buffer frames shade in plain
    ops."""
    renders = got["B1"] + got["B2"] + got["B7"]
    if got["S"] != renders:
        return (f"{label}: the shade kernel launched {got['S']} times for "
                f"{renders} raster renders")
    return None


def _zero(counters) -> None:
    for c in counters.values():
        c.launches = 0


def cli_run(cli, dev, argv, counters, stale) -> tuple[str, dict, int]:
    """cli.main(argv) on `dev` with the launch counters and the stale
    count set to 0 just before and read just after -> (stdout, launches,
    rebuilds). Raises if the CLI does not return 0."""
    _zero(counters)
    stale.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--device", dev.type])
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} returned {rc}")
    return buf.getvalue(), _launches(counters), stale.n


def cli_ms(text: str) -> float:
    """The CLI's own wall ms per frame: its loop's "N frames in Xs" line,
    or the turntable's median."""
    m = re.search(r"(\d+) frames in ([0-9.]+)s", text)
    if m:
        return float(m.group(2)) * 1e3 / int(m.group(1))
    return float(re.search(r"median ([0-9.]+) ms/frame", text).group(1))


def png_diff(fbm, path: str, fb) -> int:
    """Pixels of the PNG at `path` that differ from frame `fb`'s RGB."""
    return int((fbm.read_png(path) != fbm.to_rgb8_topleft(fb)).any(
        axis=2).sum())


def app_shell(dev, card, counters, launches, tmp: str) -> str | None:
    """The app shell on the card: the CLI's rasterizer (8 frames at 512^2,
    PNGs and a GIF), its point and line modes (M, MM) on Killeroo and
    TorusKnot, the Cube (W keys, the bins), per-pixel (P), a 64-frame
    turntable of KillerooP, GoL at 256^2 over a save and a load (and an R
    key after the load), N-body at the defaults and resumed at
    APP_NBODY_LOADED, sine, and the viewer with each experiment as its
    start. Each run's launches are counted on their own: B1 once a frame
    rendered, B2 on the Cube, B4 once a GoL step (256^2, resident), B6 12
    times a BH step of a power-of-two N, and no kernel for points, lines
    and sine. The PNGs equal the card's frames, the point, line and sine
    frames the CPU's at 0 px, the resumed GoL the uninterrupted one bit
    for bit. Returns a failure message or None."""
    from rustexp_tpu_torch.app import cli, viewer
    from rustexp_tpu_torch.core import framebuffer as fbm
    from rustexp_tpu_torch.core.checkpoint import load_state, save_state
    from rustexp_tpu_torch.ops import gol_bits as gb
    from rustexp_tpu_torch.sims.gol import GoLExperiment
    from rustexp_tpu_torch.sims.nbody import NBodyExperiment
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment
    from rustexp_tpu_torch.sims.sine import SineExperiment

    cpu = torch.device("cpu")
    stale = _StaleCount(os.path.join(tmp, "trace.log"))
    tpf = 1.0 / 60.0  # the CLI's default ticks per frame

    shade_faults = []

    def report(label, text, got, frames):
        kept = {k: v for k, v in got.items() if v}
        print(f"app {label}: {cli_ms(text):.3f} ms/frame wall (the CLI's "
              f"loop, host clock, {frames} frames), launches {kept} "
              f"[{card}]", flush=True)
        for k in counters:
            launches[k] += got[k]
        shade_faults.append(shade_per_render(f"app {label}", got))

    def raster_frames(exp_dev, keys, ticks):
        exp = RasterizerExperiment(exp_dev)
        st = exp.init()
        for k in keys:
            st = exp.handle_key(st, k)
        return [exp.render(st, W, H, t) for t in ticks]

    # 1. the rasterizer at 512^2: B1 once a frame rendered; PNGs = frames
    out = os.path.join(tmp, "r")
    text, got, rebuilt = cli_run(cli, dev, [
        "rasterizer", "--frames", str(APP_FRAMES), "--size", str(W),
        "--no-overlay", "--out", out, "--gif", out + ".gif"], counters,
        stale)
    report(f"rasterizer KillerooV {W}x{H} (queue, PNG and GIF)", text, got,
           APP_FRAMES)
    if got["B1"] != APP_FRAMES + rebuilt:
        return (f"app rasterizer: B1 launched {got['B1']} times for "
                f"{APP_FRAMES} frames and {rebuilt} rebuilds")
    last = APP_FRAMES - 1
    ticks = (0.0, last * tpf)
    for d in (dev, cpu):
        for i, fb in zip((0, last), raster_frames(d, "", ticks)):
            diff = png_diff(fbm, f"{out}_{i:03d}.png", fb)
            print(f"app rasterizer frame {i}: {diff} px of the PNG differ "
                  f"from the {d.type} frame", flush=True)
            if diff > (0 if d == dev else GOLDEN_FRAC * W * H):
                return f"app rasterizer frame {i}: {diff} px differ ({d})"
    with open(out + ".gif", "rb") as f:
        if f.read(6) != b"GIF89a":
            return "app rasterizer: no GIF"

    # 2. points and lines: no kernel; the card's PNGs = the CPU's frames
    for label, keys in APP_MODE_KEYS:
        out = os.path.join(tmp, "m")
        text, got, _ = cli_run(cli, dev, [
            "rasterizer", "--frames", str(APP_MODE_FRAMES), "--size", str(W),
            "--keys", keys, "--no-overlay", "--out", out], counters, stale)
        report(f"{label} {W}x{H}", text, got, APP_MODE_FRAMES)
        if any(got[k] for k in ("B1", "B2", "B3", "B7")):
            return f"app {label}: a raster kernel launched ({got})"
        ticks = [i * tpf for i in range(APP_MODE_FRAMES)]
        for i, fb in enumerate(raster_frames(cpu, keys, ticks)):
            diff = png_diff(fbm, f"{out}_{i:03d}.png", fb)
            white = int((fbm.read_png(f"{out}_{i:03d}.png") == 255).all(
                axis=2).sum())
            print(f"app {label} frame {i}: {white} white px, {diff} px "
                  f"differ from the CPU frame", flush=True)
            if diff or white < 100:
                return f"app {label} frame {i}: {diff} px differ, {white} white"

    # 3. the Cube (the bins, B2) and KillerooP (B1)
    for label, keys, kernel in (("CubeV (W keys)", "WWWWWWWWW", "B2"),
                                ("KillerooP (P)", "P", "B1")):
        text, got, rebuilt = cli_run(cli, dev, [
            "rasterizer", "--frames", str(APP_BINS_FRAMES), "--size", str(W),
            "--keys", keys], counters, stale)
        report(f"{label} {W}x{H}", text, got, APP_BINS_FRAMES)
        if got[kernel] != APP_BINS_FRAMES + rebuilt:
            return (f"app {label}: {kernel} launched {got[kernel]} times for "
                    f"{APP_BINS_FRAMES} frames and {rebuilt} rebuilds")

    # 4. the turntable: a queue built every frame, one warm-up frame
    text, got, _ = cli_run(cli, dev, [
        "rasterizer", "--keys", "P", "--animate", str(APP_TURNTABLE),
        "--size", str(W)], counters, stale)
    report(f"turntable KillerooP {W}x{H} (--animate, median)", text, got,
           APP_TURNTABLE)
    if got["B1"] != APP_TURNTABLE + 1:
        return f"app turntable: B1 launched {got['B1']} times"

    # 5. GoL at 256^2: 16 frames, save, load, 16 more = 32 in one run;
    # after the load an R key draws what the uninterrupted run draws
    per_step = gb._b4_plan(256 // 32, 256, 1).launches
    st = {n: os.path.join(tmp, f"gol{n}") for n in range(1, 5)}
    gol_runs = (
        ("GoL 256x256", ["--save-state", st[1]], APP_GOL_FRAMES),
        ("GoL 256x256 resumed", ["--load-state", st[1], "--save-state",
                                 st[2]], APP_GOL_FRAMES),
        ("GoL 256x256 uninterrupted", ["--save-state", st[3]],
         2 * APP_GOL_FRAMES),
        ("GoL 256x256 resumed, R", ["--load-state", st[1], "--keys", "R",
                                    "--save-state", st[4]], APP_GOL_FRAMES))
    for label, argv, frames in gol_runs:
        text, got, _ = cli_run(cli, dev, ["gol", "--frames", str(frames),
                                     "--size", "256", *argv], counters, stale)
        report(label, text, got, frames)
        if got["B4"] != frames * per_step:
            return f"app {label}: B4 launched {got['B4']} times"
    gol = GoLExperiment(dev)
    ref, ref_r = gol.init(), gol.init()
    for _ in range(APP_GOL_FRAMES):
        ref, ref_r = gol.step(ref), gol.step(ref_r)
    ref_r = gol.handle_key(ref_r, "R")
    for _ in range(APP_GOL_FRAMES):
        ref, ref_r = gol.step(ref), gol.step(ref_r)
    resumed, whole = load_state(st[2], gol), load_state(st[3], gol)
    after_r = load_state(st[4], gol)
    bad = (int((resumed.grid != whole.grid).sum()),
           int((whole.grid != ref.grid).sum()),
           int((after_r.grid != ref_r.grid).sum()))
    print(f"app GoL: resumed against uninterrupted {bad[0]} cells differ, "
          f"the CLI's 32 frames against the Experiment's {bad[1]}, resumed "
          f"with R against the Experiment's R {bad[2]}; live "
          f"{int(whole.grid.sum())} [{card}]", flush=True)
    if any(bad) or resumed.generations != 2 * APP_GOL_FRAMES:
        return f"app GoL: resume differs {bad}"

    # 6. N-body at the defaults (10,000: argsort) and resumed at a power
    # of two (B6, 12 launches a BH step)
    nb_path = save_state(os.path.join(tmp, "nbody"), NBodyExperiment(
        dev).init(n=APP_NBODY_LOADED))
    for label, argv, b6 in (
            ("N-body defaults (10,000, BH, argsort)", [], 0),
            (f"N-body resumed at {APP_NBODY_LOADED} (BH, B6)",
             ["--load-state", nb_path], 12 * APP_FRAMES)):
        text, got, _ = cli_run(cli, dev, ["nbody", "--frames", str(APP_FRAMES),
                                     "--size", str(W), *argv], counters,
                               stale)
        report(label, text, got, APP_FRAMES)
        if got["B6"] != b6:
            return f"app {label}: B6 launched {got['B6']} times, not {b6}"

    # 7. sine: no kernel; the card's PNGs = the CPU's frames
    out = os.path.join(tmp, "s")
    text, got, _ = cli_run(cli, dev, ["sine", "--frames", str(APP_SINE_FRAMES),
                                 "--size", str(W), "--no-overlay", "--out",
                                 out], counters, stale)
    report(f"sine {W}x{H}", text, got, APP_SINE_FRAMES)
    exp = SineExperiment(cpu)
    sst = exp.init()
    for i in range(APP_SINE_FRAMES):
        sst = exp.step(sst)
        diff = png_diff(fbm, f"{out}_{i:03d}.png", exp.render(sst, W, H))
        if diff:
            return f"app sine frame {i}: {diff} px differ from the CPU's"
    print(f"app sine: {APP_SINE_FRAMES} frames, 0 px differ from the CPU's",
          flush=True)

    # 8. the viewer, headless, each experiment as its start
    for start, kernel in ((0, "B4"), (1, None), (2, "B1")):
        _zero(counters)
        stale.reset()
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            n = viewer.run_viewer(size=APP_VIEWER_SIZE, fps=1000.0,
                                  frames=APP_VIEWER_FRAMES, start=start,
                                  report=True, device=dev)
        got = _launches(counters)
        rec = json.loads(err.getvalue().strip().splitlines()[-1])
        print(f"app viewer report {json.dumps(rec)}; launches "
              f"{ {k: v for k, v in got.items() if v} } [{card}]",
              flush=True)
        for k in counters:
            launches[k] += got[k]
        shade_faults.append(shade_per_render(f"app viewer start {start}",
                                             got))
        if n != APP_VIEWER_FRAMES or rec["frames"] != n:
            return f"app viewer start {start}: {n} frames"
        if kernel == "B1" and got["B1"] != n + stale.n:
            return f"app viewer: B1 launched {got['B1']} times for {n} frames"
        if kernel == "B4" and got["B4"] == 0:
            return "app viewer: GoL's worker never launched B4"
    stale.close()
    return next((m for m in shade_faults if m), None)


SHARD_RANKS = 4          # gloo ranks sharing the one card
SHARD_ODD_RANKS = 3      # the odd-even sort schedule
SHARD_MOVING_FRAMES = 8  # KillerooP's camera path, queues rebuilt a frame
SHARD_GOL = (("bits", 2048, 64), ("pallas", 256, 8))  # body, N, k
SHARD_BH_N, SHARD_BH_ODD_N, SHARD_BH_STEPS = 131072, 98304, 2
SHARD_BRUTE_N = 8192
SHARD_BRUTE_TOL = 2e-4   # tests/test_parallel.py:58, JAX's own bound
SHARD_TIMED = 4          # timed calls a rank, after a warm-up call
SHARD_CLI_FRAMES = 4


def _rank_times(fn, dev) -> dict:
    """This rank's wall ms per fn() call (host clock, synchronized) over
    SHARD_TIMED calls after a warm-up, and its device-busy ms per call
    (the union of its own activities in one torch.profiler session,
    between spin-kernel pads; None, "not measured", when a pad record was
    lost). Every rank makes the same calls: no session is run again, as
    the collectives inside fn() must meet."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(SHARD_TIMED):
        fn()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3 / SHARD_TIMED
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(dev)
        for _ in range(SHARD_TIMED):
            fn()
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(dev)
        time.sleep(0.05)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = [e for e in events if "spin_kernel" in e.name]
    work = [e for e in events if "spin_kernel" not in e.name]
    kept = work and len(spins) == 2 and spins[0].time_range.start < min(
        e.time_range.start for e in work) and spins[1].time_range.start > max(
        e.time_range.start for e in work)
    return {"wall_ms": wall,
            "busy_ms": busy_ms(work) / SHARD_TIMED if kept else None}


def _frame_digest(fb) -> str:
    import hashlib

    return hashlib.sha256(fb.cpu().view(torch.int32).numpy().tobytes()
                          ).hexdigest()


def _bits_differ(a, b) -> int:
    """Elements of a and b (same shape, 4-byte types) whose bits differ."""
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def _b1_vs_plain(scene, queue, eye, band, n_dev, layout, per_pixel) -> dict:
    """B1 against its plain version on this band's own inputs, built as
    raster_shard.queue_band builds them (tick 0, shader 5): the slot bit
    for bit, z and the planes where the slot is set -> {"bad", "words"}."""
    from rustexp_tpu_torch.ops import raster_queue as rq
    from rustexp_tpu_torch.raster import pipeline as pp

    band_h, cyclic = H // n_dev, layout == "cyclic"
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H,
                                                     5)
    setup, extra, n2, n3 = pp.queue_attr_channels(
        scene, colors, eye, W, H, per_pixel=per_pixel, ray_world=True,
        band_h=None if cyclic else band_h,
        y_shift=0 if cyclic else band * band_h)
    rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
    args = (queue.scal, rows_i, rows_f, n2, n3, band_h, W)
    zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
    zp, sp, lp = rq.raster_attrs_queue_plain(*args)
    mask = sp >= 0
    bad = (_bits_differ(sk, sp) + _bits_differ(zk[mask], zp[mask])
           + _bits_differ(lk[:, mask], lp[:, mask]))
    return {"bad": bad, "words": sp.numel() + int(mask.sum()) * (
        1 + lp.shape[0])}


def _gol_vs_plain(grid, rank, n_dev, backend, k, dev) -> dict:
    """B4 ("bits") or B8 ("pallas") against its plain version on this
    rank's own halo-padded block, the rows gol_shard's body hands the
    kernel (the halo 16-row rounded for "bits", k rows for "pallas")
    -> {"bad", "words"}."""
    from rustexp_tpu_torch.ops import gol_bits, gol_stencil

    n = grid.shape[0]
    r = n // n_dev
    halo = -(-k // 16) * 16 if backend == "bits" else k
    block = grid[(torch.arange(-halo, r + halo) + rank * r) % n].to(dev)
    if backend == "bits":
        packed = gol_bits.pack_rows(block)
        got = gol_bits.multi_step_packed_cuda(packed, k)
        want = gol_bits.multi_step_packed_plain(packed, k)
    else:
        g = block.to(torch.float32).contiguous()
        got = gol_stencil.multi_step_pallas_cuda(g, k)
        want = gol_stencil.multi_step_pallas_plain(g, k)
    return {"bad": _bits_differ(got, want), "words": want.numel()}


def _b6_vs_plain(arrs, rank, n_dev) -> dict:
    """B6 in its merge_kv form against sort_kv_plain on this rank's own
    inputs of the first distributed-sort BH step: the local sort (its
    Morton codes and global positions, carrying px, py, m, vx, vy) and the
    first merge (Batcher's split of its sorted chunk against its hypercube
    partner's, rank ^ 1) -> {"bad", "words"}."""
    from rustexp_tpu_torch.ops import sort_bitonic as sb
    from rustexp_tpu_torch.ops.nbody_bh import morton_codes

    px, py, vx, vy, m = arrs
    n_loc = px.shape[0] // n_dev
    code = morton_codes(px, py, px.min(), px.max(), py.min(), py.max())

    def chunk(d):
        s = slice(d * n_loc, (d + 1) * n_loc)
        gidx = torch.arange(d * n_loc, (d + 1) * n_loc, dtype=torch.int32,
                            device=px.device)
        return code[s], gidx, [px[s], py[s], m[s], vx[s], vy[s]]

    (k, g, v), (pk, pg, pv) = (sb.sort_kv_plain(*chunk(d))
                               for d in (rank, rank ^ 1))
    pk, pg, pv = pk.flip(0), pg.flip(0), [x.flip(0) for x in pv]
    mine = (k < pk) | ((k == pk) & (g < pg))
    keep = mine if ((rank & 1) == 0) == ((rank & 2) == 0) else ~mine
    split = (torch.where(keep, k, pk), torch.where(keep, g, pg),
             [torch.where(keep, a, b) for a, b in zip(v, pv)])
    bad = words = 0
    for key, gidx, vals in (chunk(rank), split):
        got, want = sb.merge_kv(key, gidx, vals), sb.sort_kv_plain(
            key, gidx, vals)
        bad += (_bits_differ(got[0], want[0]) + _bits_differ(got[1], want[1])
                + sum(_bits_differ(a, b) for a, b in zip(got[2], want[2])))
        words += (2 + len(vals)) * n_loc
    return {"bad": bad, "words": words}


def _shard_rank(group, dev) -> dict:
    """One of SHARD_RANKS gloo ranks on the card: the queue bands of
    KillerooP and KillerooV in both layouts, the moving form, the G-buffer
    bands through B3, GoL through B4 ("bits") and B8 ("pallas"), block BH
    with the distributed sort (B6) and the brute step. Returns rank 0's
    frames and every rank's digests of them, its shards of the GoL grids
    and particles, its launches and its times, and B1, B4, B6 and B8 held
    against their plain versions on this rank's own inputs (after the
    counted runs, so those launches are not counted)."""
    from rustexp_tpu_torch.app.multidev import kernel_launches
    from rustexp_tpu_torch.assets import cubemap, mesh as meshes
    from rustexp_tpu_torch.core import prng
    from rustexp_tpu_torch.ops.nbody_bh import theta_to_k
    from rustexp_tpu_torch.parallel import collectives as coll
    from rustexp_tpu_torch.parallel import gol_shard, nbody_shard
    from rustexp_tpu_torch.parallel import raster_shard
    from rustexp_tpu_torch.raster import camera, pipeline as pp
    from rustexp_tpu_torch.sims.nbody import stable_orbits

    n_dev, rank = coll.world(group)
    out = {"frames": {}, "digests": {}, "launches": {}, "times": {},
           "shards": {}, "plain": {}}

    def counted(label, fn):
        before = kernel_launches()
        res = fn()
        torch.cuda.synchronize(dev)
        out["launches"][label] = {k: v - before[k] for k, v in
                                  kernel_launches().items() if v - before[k]}
        return res

    def keep(label, fb):
        out["digests"][label] = _frame_digest(fb)
        if rank == 0:
            out["frames"][label] = fb.cpu().view(torch.int32).numpy()

    cam = meshes.mesh_camera(0)
    eye = camera.camera_eye(cam, 0.0)
    scene = pp.make_scene(meshes.get_mesh(0), cubemap.get_cm_set(0), dev)
    for layout in raster_shard.LAYOUTS:
        caps = raster_shard.band_queue_caps(scene, [eye], w=W, h=H,
                                            n_dev=n_dev, layout=layout,
                                            group=group)
        queue = raster_shard.build_band_queue(scene, eye, caps, w=W, h=H,
                                              n_dev=n_dev, band=rank,
                                              layout=layout)
        for per_pixel in (True, False):
            label = f"Killeroo{'P' if per_pixel else 'V'} {layout}"
            render = raster_shard.make_sharded_queue_render(
                group, scene, eye, w=W, h=H, per_pixel=per_pixel,
                shader_idx=5, layout=layout)
            fb, stale = counted(label, lambda: render(scene, queue, eye, 0.0))
            if bool(stale):
                raise RuntimeError(f"{label}: stale band queue")
            keep(label, fb)
            if per_pixel and layout == "bands":
                out["times"][f"queue frame {label}"] = _rank_times(
                    lambda: render(scene, queue, eye, 0.0), dev)
            out["plain"][f"B1 {label}"] = _b1_vs_plain(
                scene, queue, eye, rank, n_dev, layout, per_pixel)

    ticks = [i / 60.0 for i in range(SHARD_MOVING_FRAMES)]
    moving = raster_shard.make_sharded_queue_render_moving(
        group, scene, [camera.camera_eye(cam, t) for t in ticks], w=W, h=H,
        per_pixel=True, shader_idx=5)

    def path():
        frames = []
        for t in ticks:
            fb, stale = moving(scene, camera.camera_eye(cam, t), t)
            if bool(stale):
                raise RuntimeError(f"moving KillerooP tick {t}: stale caps")
            frames.append(fb)
        return frames

    for i, fb in enumerate(counted("KillerooP moving", path)):
        keep(f"KillerooP moving {i}", fb)
    e21 = camera.camera_eye(cam, ticks[-1])
    out["times"]["moving frame KillerooP"] = _rank_times(
        lambda: moving(scene, e21, ticks[-1]), dev)
    fb = counted("KillerooV G-buffer bands", lambda: raster_shard.
                 render_frame_sharded(scene, eye, 0.0, group, w=W, h=H,
                                      backend="pallas"))
    keep("KillerooV G-buffer bands", fb)

    for backend, n, k in SHARD_GOL:
        gen = torch.Generator().manual_seed(n)
        grid = (torch.rand((n, n), generator=gen) < 0.35).to(torch.int32)
        local = gol_shard.shard_grid(grid.to(dev), group)
        step = gol_shard.make_multi_step(group, k=k, backend=backend)
        label = f"GoL {n}x{n} {backend} k={k}"
        out["shards"][label] = counted(label, lambda: step(local)).cpu(
            ).numpy()
        out["times"][label] = _rank_times(lambda: step(local), dev)
        out["plain"][f"{'B4' if backend == 'bits' else 'B8'} {label}"] = \
            _gol_vs_plain(grid, rank, n_dev, backend, k, dev)

    arrs = stable_orbits(prng.key(0), SHARD_BH_N, device=dev)
    state = nbody_shard.shard_particles(arrs, group)
    bh = nbody_shard.make_step_bh(group, block=256, k_near=theta_to_k(
        0.85, SHARD_BH_N // 256))
    label = f"BH {SHARD_BH_N} distributed sort"

    def steps():
        st = state
        for _ in range(SHARD_BH_STEPS):
            st = bh(*st, 0.01)
        return st

    out["shards"][label] = [a.cpu().numpy() for a in counted(label, steps)]
    out["times"][f"BH step {SHARD_BH_N}"] = _rank_times(
        lambda: bh(*state, 0.01), dev)
    out["plain"][f"B6 {label}"] = _b6_vs_plain(arrs, rank, n_dev)

    arrs = stable_orbits(prng.key(1), SHARD_BRUTE_N, device=dev)
    brute = nbody_shard.make_step(group)
    sl = nbody_shard.shard_particles(arrs, group)
    label = f"brute {SHARD_BRUTE_N}"
    out["shards"][label] = [a.cpu().numpy() for a in counted(
        label, lambda: brute(*sl, 0.01))]
    out["times"][f"brute step {SHARD_BRUTE_N}"] = _rank_times(
        lambda: brute(*sl, 0.01), dev)
    return out


def _shard_odd_rank(group, dev) -> dict:
    """One of SHARD_ODD_RANKS gloo ranks: the BH steps at SHARD_BH_ODD_N,
    the odd-even transposition sort with B6 on its 32,768-body chunks."""
    from rustexp_tpu_torch.app.multidev import kernel_launches
    from rustexp_tpu_torch.core import prng
    from rustexp_tpu_torch.ops.nbody_bh import theta_to_k
    from rustexp_tpu_torch.parallel import nbody_shard
    from rustexp_tpu_torch.sims.nbody import stable_orbits

    arrs = stable_orbits(prng.key(2), SHARD_BH_ODD_N, device=dev)
    st = nbody_shard.shard_particles(arrs, group)
    bh = nbody_shard.make_step_bh(group, block=256, k_near=theta_to_k(
        0.85, SHARD_BH_ODD_N // 256))
    for _ in range(SHARD_BH_STEPS):
        st = bh(*st, 0.01)
    torch.cuda.synchronize(dev)
    return {"shards": [a.cpu().numpy() for a in st],
            "launches": kernel_launches()}


def _nccl_rank(group, dev) -> dict:
    """The NCCL branch of the backend choice: a group of world size 1 on
    cuda:0, one all_reduce through NCCL and the dry run's steps."""
    import torch.distributed as dist

    from rustexp_tpu_torch.app.multidev import _dryrun_rank

    t = torch.arange(4, dtype=torch.float32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    res = _dryrun_rank(group, dev)
    res["backend"] = dist.get_backend(group)
    res["all_reduce"] = t.tolist()
    return res


def sharded_paths(dev, card, launches, tmp: str) -> str | None:
    """The sharded paths (ROADMAP A16) as ranks on the one card: the
    SHARD_RANKS gloo ranks of _shard_rank, the SHARD_ODD_RANKS of
    _shard_odd_rank, the CLI's --devices 4 on each experiment and one NCCL
    rank. Every result is held against this process's one-rank card
    result: frames at 0 px (cyclic ones after deinterleave_rows), GoL
    grids and BH particles bit for bit, the brute step within
    SHARD_BRUTE_TOL. Prints each rank's launches and times. Returns a
    failure message or None."""
    import numpy as np

    from rustexp_tpu_torch.app import cli
    from rustexp_tpu_torch.assets import cubemap, mesh as meshes
    from rustexp_tpu_torch.core import framebuffer as fbm, prng
    from rustexp_tpu_torch.ops import gol_bits, gol_stencil, nbody_bh
    from rustexp_tpu_torch.ops.nbody_forces import step_brute_force
    from rustexp_tpu_torch.parallel import collectives as coll
    from rustexp_tpu_torch.parallel import raster_shard
    from rustexp_tpu_torch.raster import camera, pipeline as pp
    from rustexp_tpu_torch.sims.gol import GoLExperiment, gol_render
    from rustexp_tpu_torch.sims.nbody import nbody_render, stable_orbits
    from rustexp_tpu_torch.sims.sine import sine_frame

    name, limit = (x.strip() for x in card.split(","))
    shared = (f"{SHARD_RANKS} ranks sharing one {name} (power limit "
              f"{limit}) over gloo")
    t0 = time.perf_counter()
    res = coll.spawn_ranks(_shard_rank, SHARD_RANKS, dev, timeout=600)
    print(f"sharded: {SHARD_RANKS} gloo ranks ran in "
          f"{time.perf_counter() - t0:.1f} s (spawn included) [{card}]",
          flush=True)
    for r, rr in enumerate(res):
        print(f"sharded rank {r} launches {json.dumps(rr['launches'])} "
              f"[{shared}]", flush=True)
        for k in launches:
            launches[k] += sum(v.get(k, 0) for v in rr["launches"].values())
        for label, t in rr["times"].items():
            busy = ("not measured (a pad record was lost)"
                    if t["busy_ms"] is None else f"{t['busy_ms']:.4f} ms")
            print(f"time sharded rank {r} {label}: wall {t['wall_ms']:.4f} "
                  f"ms (host clock), device busy {busy} (profiler, this "
                  f"rank's own activities) [{shared}; not a scaling "
                  f"figure]", flush=True)

    # launches a rank: B1 once a frame rendered, B3 once, B4 and B8 as
    # planned, B6 (1 local sort + 3 merges) x 24 a BH step
    band_rows = 2048 // SHARD_RANKS + 2 * 64
    want = {f"Killeroo{v} {lay}": {"B1": 1} for v in "PV"
            for lay in ("bands", "cyclic")}
    want.update({
            "KillerooP moving": {"B1": SHARD_MOVING_FRAMES},
            "KillerooV G-buffer bands": {"B3": 1},
            "GoL 2048x2048 bits k=64": {"B4": gol_bits._b4_plan(
                band_rows // 32, 2048, 64).launches},
            "GoL 256x256 pallas k=8": {"B8": gol_stencil._b8_plan(
                256 // SHARD_RANKS + 16, 256, 8).launches},
            f"BH {SHARD_BH_N} distributed sort": {
                "B6": (1 + 3) * SHARD_BH_STEPS * 24},
            f"brute {SHARD_BRUTE_N}": {}})
    for rr in res:
        for label, w in want.items():
            if rr["launches"][label] != w:
                return (f"sharded {label}: launches {rr['launches'][label]}"
                        f", not {w}")

    # each rank's kernels against their plain versions on its own inputs
    for r, rr in enumerate(res):
        print(f"sharded rank {r} kernels against their plain versions on "
              f"its own inputs: " + "; ".join(
                  f"{label}: {c['bad']} of {c['words']} words differ"
                  for label, c in rr["plain"].items()) + f" [{shared}]",
              flush=True)
        for label, c in rr["plain"].items():
            if c["bad"] or not c["words"]:
                return (f"sharded rank {r} {label}: {c['bad']} of "
                        f"{c['words']} words differ from the plain version")

    # frames: every rank gathered the same frame; rank 0's = one rank's
    scene = pp.make_scene(meshes.get_mesh(0), cubemap.get_cm_set(0), dev)
    cam = meshes.mesh_camera(0)

    def one_rank(t, per_pixel=True):
        eye = camera.camera_eye(cam, t)
        q = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
        return pp.render_frame(scene, eye, t, w=W, h=H, per_pixel=per_pixel,
                               shader_idx=5, backend="queue",
                               raster_queue=q, show_cm=False)

    refs = {f"Killeroo{'P' if p else 'V'} {lay}": one_rank(0.0, p)
            for p in (True, False) for lay in raster_shard.LAYOUTS}
    for i in range(SHARD_MOVING_FRAMES):
        refs[f"KillerooP moving {i}"] = one_rank(i / 60.0)
    refs["KillerooV G-buffer bands"] = raster_shard.render_frame_sharded(
        scene, camera.camera_eye(cam, 0.0), 0.0, None, w=W, h=H,
        backend="pallas")
    worst = 0
    for label, ref in refs.items():
        got = torch.from_numpy(res[0]["frames"][label])
        if "cyclic" in label:
            got = raster_shard.deinterleave_rows(got, SHARD_RANKS)
        diff = int((got != ref.cpu().view(torch.int32)).sum())
        same = {rr["digests"][label] for rr in res}
        worst = max(worst, diff)
        if diff or len(same) != 1:
            return (f"sharded {label}: {diff} px differ from the one-rank "
                    f"card frame, {len(same)} distinct gathered frames")
    print(f"sharded frames: {len(refs)} frames (KillerooP/V 512x512 in both "
          f"layouts, {SHARD_MOVING_FRAMES} moving, the G-buffer bands), "
          f"{worst} px differ from the one-rank card frames [{shared}]",
          flush=True)

    for backend, n, k in SHARD_GOL:
        label = f"GoL {n}x{n} {backend} k={k}"
        gen = torch.Generator().manual_seed(n)
        grid = (torch.rand((n, n), generator=gen) < 0.35).to(torch.int32)
        one = (gol_bits.multi_step_swar(grid.to(dev), k) if backend == "bits"
               else gol_stencil.multi_step_pallas(grid.to(dev), k)).cpu()
        got = np.concatenate([rr["shards"][label] for rr in res])
        bad = int((got != one.numpy()).sum())
        print(f"sharded {label}: {bad} cells differ from one-rank "
              f"{'B4' if backend == 'bits' else 'B8'}, live "
              f"{int(one.sum())} [{shared}]", flush=True)
        if bad:
            return f"sharded {label}: {bad} cells differ"

    def bh_check(label, got_shards, n, seed, ranks):
        st = stable_orbits(prng.key(seed), n, device=dev)
        k = nbody_bh.theta_to_k(0.85, n // 256)
        for _ in range(SHARD_BH_STEPS):
            st = nbody_bh.step_bh(*st, 256, k, 0.01)
        bad = sum(int((np.concatenate(g) != a.cpu().numpy()).sum())
                  for g, a in zip(got_shards, st))
        print(f"sharded {label}: {bad} of {5 * n} words differ from one-rank "
              f"step_bh after {SHARD_BH_STEPS} steps [{ranks} ranks sharing "
              f"one {name} (power limit {limit}) over gloo]", flush=True)
        return None if bad == 0 else f"sharded {label}: {bad} words differ"

    label = f"BH {SHARD_BH_N} distributed sort"
    msg = bh_check(label, [[rr["shards"][label][j] for rr in res]
                           for j in range(5)], SHARD_BH_N, 0, SHARD_RANKS)
    if msg:
        return msg
    arrs = stable_orbits(prng.key(1), SHARD_BRUTE_N, device=dev)
    want_b = step_brute_force(*arrs, dt=0.01)
    label = f"brute {SHARD_BRUTE_N}"
    err = max(float((torch.from_numpy(np.concatenate(
        [rr["shards"][label][j] for rr in res])) - w.cpu()).abs().max())
        for j, w in enumerate(want_b))
    print(f"sharded {label}: largest |difference| {err:.3e} from the "
          f"one-rank brute step (bound {SHARD_BRUTE_TOL}) [{shared}]",
          flush=True)
    if not err <= SHARD_BRUTE_TOL:
        return f"sharded {label}: {err} from the one-rank step"

    # the odd-even schedule: 3 ranks, B6 on 32,768-body chunks
    odd = coll.spawn_ranks(_shard_odd_rank, SHARD_ODD_RANKS, dev,
                           timeout=300)
    for r, rr in enumerate(odd):
        got = {k: v for k, v in rr["launches"].items() if v}
        print(f"sharded odd-even rank {r} launches {json.dumps(got)} "
              f"[{SHARD_ODD_RANKS} ranks sharing one {name} (power limit "
              f"{limit}) over gloo]", flush=True)
        for k in launches:
            launches[k] += rr["launches"].get(k, 0)
        if got != {"B6": (1 + SHARD_ODD_RANKS) * SHARD_BH_STEPS * 24}:
            return f"sharded odd-even rank {r}: launches {got}"
    msg = bh_check(f"BH {SHARD_BH_ODD_N} odd-even sort",
                   [[rr["shards"][j] for rr in odd] for j in range(5)],
                   SHARD_BH_ODD_N, 2, SHARD_ODD_RANKS)
    if msg:
        return msg

    # the CLI's --devices 4: PNGs = the one-rank card frames
    expect = {}
    g = GoLExperiment(dev).init(n=256).grid.to(torch.int32)
    expect["gol"] = []
    for _ in range(SHARD_CLI_FRAMES):
        g = gol_stencil.multi_step(g, 8, "roll")
        expect["gol"].append(gol_render(g, W, H))
    st = stable_orbits(prng.key(0), 256 * 8 * SHARD_RANKS, device=dev)
    expect["nbody"] = []
    for _ in range(SHARD_CLI_FRAMES):
        st = nbody_bh.step_bh(*st, 256, nbody_bh.theta_to_k(0.85, 32), 0.01)
        expect["nbody"].append(nbody_render(*st[:4], W, H))
    expect["rasterizer"] = [one_rank(i / 60.0, False)
                            for i in range(SHARD_CLI_FRAMES)]
    expect["sine"] = [sine_frame(W, H, i / 60.0, dev)
                      for i in range(SHARD_CLI_FRAMES)]
    per_frame = {"gol": {"B8": 1}, "nbody": {"B6": 4 * 24},
                 "rasterizer": {"B1": 1}, "sine": {}}
    for experiment, frames in expect.items():
        out = os.path.join(tmp, f"dev4_{experiment}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([experiment, "--devices", str(SHARD_RANKS),
                           "--frames", str(SHARD_CLI_FRAMES), "--size",
                           str(W), "--no-overlay", "--out", out])
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        if rc != 0:
            return f"cli {experiment} --devices {SHARD_RANKS} returned {rc}"
        diff = sum(png_diff(fbm, f"{out}_{i:03d}.png", fb)
                   for i, fb in enumerate(frames))
        got = [json.loads(m.replace("'", '"')) for m in re.findall(
            r"rank \d+ kernel launches: (\{.*\})", text)]
        want_l = {k: v * SHARD_CLI_FRAMES
                  for k, v in per_frame[experiment].items()}
        if experiment == "rasterizer" and got:
            # a frame whose queue went stale renders again on every rank,
            # once its caps are widened
            want_l["B1"] = max(want_l["B1"], got[0].get("B1", 0))
        print(f"sharded cli {experiment} --devices {SHARD_RANKS} "
              f"{W}x{W}: {diff} px of {SHARD_CLI_FRAMES} PNGs differ from "
              f"the one-rank card frames; launches a rank {got}; "
              f"{text.strip().splitlines()[-1]}; {wall:.1f} s with the "
              f"spawn [{shared}]", flush=True)
        if diff or len(got) != SHARD_RANKS or any(
                x != want_l for x in got):
            return (f"sharded cli {experiment}: {diff} px differ, launches "
                    f"{got}, not {want_l} a rank")
        for x in got:
            for k, v in x.items():
                launches[k] += v

    # one NCCL group of world size 1: the backend choice's NCCL branch
    nccl = coll.spawn_ranks(_nccl_rank, 1, dev, timeout=300)[0]
    got = {k: v for k, v in nccl["launches"].items() if v}
    print(f"sharded NCCL world size 1 on {dev}: backend {nccl['backend']}, "
          f"all_reduce {nccl['all_reduce']}, dry-run steps "
          f"{len(nccl['steps'])}, launches {json.dumps(got)} [{card}]",
          flush=True)
    if nccl["backend"] != "nccl" or len(nccl["steps"]) != 9:
        return f"sharded NCCL rank: {nccl['backend']}, {nccl['steps']}"
    for k in launches:
        launches[k] += nccl["launches"].get(k, 0)
    return None


# The two top-level surfaces (surfaces below). SUMMARY_KEYS: the keys of
# the root bench.py's summary line over every step's record (its
# compose_summary; tests/test_torch_bench.py holds the two lists equal).
SUMMARY_KEYS = (
    "metric", "value", "unit", "vs_baseline", "suite_total_us",
    "scenes_done", "scene_us", "scene_spread_pct", "gol_cell_updates_per_s",
    "gol_gens_per_s", "gol_spread_pct", "gol_256_note",
    "gol_2048_cell_updates_per_s", "gol_2048_spread_pct",
    "nbody_bh_steps_per_s_131k", "nbody_bh_spread_pct",
    "nbody_brute_steps_per_s_131k", "moving_suite_total_us",
    "moving_scenes_done", "moving_vs_baseline", "moving_scene_us",
    "moving_scene_spread_pct", "raster_moving_camera_us_KillerooP", "sha",
    "engine_hash")
BENCH_KERNELS = ("B1", "B2", "B4", "B5", "B6")  # the bench's steps launch
BENCH_TIMEOUT_S = 900


def surfaces(dev, card, counters, launches) -> tuple[str | None, dict]:
    """The port's two top-level surfaces as a user calls them.

    `python -m rustexp_tpu_torch.bench` in a fresh process: it must exit
    0 with a last line that parses, `metric` raster_suite_Mpix_per_s, 12
    fixed and 12 moving scenes, exactly the keys of bench.py's full
    summary (SUMMARY_KEYS) and no `partial`; each fixed scene's record
    on stderr (`# recorded scene:<name>: {...}`) must hold bench_scene's
    timed runs at bench.py's runs (2), and its launches on stderr (`#
    launches scene:<name>: {...}`, counted over that step alone) exactly
    its raster kernel once a frame: 3,072 of B1 on the queue scenes, of
    B2 on CubeV and CubeP, and no other kernel; the launches of the whole
    run must include each kernel its steps run (BENCH_KERNELS), and count
    on the main path. Then graft_entry.entry()'s flagship frame on the card
    against the same frame on the CPU: 0 px, B2 launched once and no other
    kernel. Returns a failure message or None, and the fixed scenes'
    records by scene name."""
    from rustexp_tpu_torch import graft_entry
    from rustexp_tpu_torch.app import benchmark as bench
    from rustexp_tpu_torch.assets import mesh as meshes

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "rustexp_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in out.stderr.splitlines():
        if line.startswith(("# device", "# launches", "# watchdog")) or (
                " failed: " in line):
            print(f"bench stderr {line}", flush=True)
    last = (out.stdout.strip().splitlines() or [""])[-1]
    print(f"bench line {last} [{card}]", flush=True)
    print(f"time bench: python -m rustexp_tpu_torch.bench {wall:.1f} s "
          f"wall (host clock), rc {out.returncode} [{card}]", flush=True)
    if out.returncode != 0:
        return (f"the bench exited {out.returncode}: "
                f"{out.stderr.strip()[-2000:]}"), {}
    try:
        line = json.loads(last)
    except ValueError:
        return f"the bench's last line does not parse: {last[:200]}", {}
    if line.get("metric") != "raster_suite_Mpix_per_s" or (
            line.get("scenes_done"), line.get("moving_scenes_done")) != (
            12, 12) or "partial" in line:
        return (f"the bench's line: metric {line.get('metric')}, scenes "
                f"{line.get('scenes_done')}, moving "
                f"{line.get('moving_scenes_done')}, partial "
                f"{line.get('partial')}"), {}
    if set(line) != set(SUMMARY_KEYS):
        return (f"the bench's keys: missing "
                f"{sorted(set(SUMMARY_KEYS) - set(line))}, extra "
                f"{sorted(set(line) - set(SUMMARY_KEYS))}"), {}
    scenes = {m.group(1): ast.literal_eval(m.group(2)) for m in re.finditer(
        r"^# recorded scene:(\w+): (\{.*\})$", out.stderr, re.M)}
    timed = max(1, BENCH_SCENE_RUNS // 8)
    if len(scenes) != 12 or len(line["scene_us"]) != 12 or any(
            r["n_runs"] != timed for r in scenes.values()):
        return (f"the bench timed {len(scenes)} fixed scenes, runs "
                f"{ {k: r['n_runs'] for k, r in scenes.items()} }, not 12 "
                f"scenes of {timed}"), scenes
    steps = {m.group(1): json.loads(m.group(2)) for m in re.finditer(
        r"^# launches scene:(\w+): (\{.*\})$", out.stderr, re.M)}
    for label, mesh_idx, _, _ in bench.SCENES:
        kernel = "B1" if meshes.get_mesh(mesh_idx).num_tris >= (
            bench.QUEUE_MIN_TRIS) else "B2"
        want = {kernel: (1 + timed) * bench.FRAMES_PER_DISPATCH}
        if steps.get(label) != want:
            return (f"the bench's scene:{label} launched "
                    f"{steps.get(label)}, want {want}"), scenes
    m = re.search(r"^# launches: (\{.*\})$", out.stderr, re.M)
    got = json.loads(m.group(1)) if m else {}
    if not all(got.get(k) for k in BENCH_KERNELS):
        return (f"the bench launched {got}, not each of {BENCH_KERNELS}"
                ), scenes
    for k, v in got.items():
        launches[k] += v

    fn, args = graft_entry.entry()
    _zero(counters)
    fb = fn(*args)
    torch.cuda.synchronize(dev)
    got = {k: v for k, v in _launches(counters).items() if v}
    cfn, cargs = graft_entry.entry("cpu")
    ref = cfn(*cargs)
    diff = int((fb.cpu().view(torch.int32) != ref.view(torch.int32)).sum())
    print(f"graft_entry.entry() Cube 512x512 per-pixel shader 5 on the card: "
          f"{diff} px differ from entry('cpu'); launches {got} [{card}]",
          flush=True)
    if fb.shape != (H, W) or fb.dtype != torch.uint32 or diff or got != {
            "B2": 1, "S": 1}:
        return (f"entry(): {diff} px differ from the CPU frame, launches "
                f"{got}"), scenes
    launches["B2"] += 1
    launches["S"] += 1
    return None, scenes


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of ptxas's -v report: its name (without the
    namespace and the argument types), registers and spills."""
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"[a-z_]+_kernel(I\w*?EE)?", m.group(1))
            name = short.group(0) if short else m.group(1)
            continue
        if "spill stores" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers; {spills}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    from rustexp_tpu_torch.app import benchmark as bench
    from rustexp_tpu_torch.assets import cubemap, mesh as meshes
    from rustexp_tpu_torch.ops import gol_bits as gb, gol_stencil as gs
    from rustexp_tpu_torch.ops import nbody_bh as bh, nbody_pallas as npl
    from rustexp_tpu_torch.ops import raster_bins as rb, raster_queue as rq
    from rustexp_tpu_torch.ops import sort_bitonic as sb
    from rustexp_tpu_torch.ops.raster_setup import setup_triangles
    from rustexp_tpu_torch.parallel import raster_shard
    from rustexp_tpu_torch.raster import camera, pipeline as pp
    from rustexp_tpu_torch.raster import shade as sd, shaders as sh
    from rustexp_tpu_torch.runtime import device, load_kernel_lib
    from rustexp_tpu_torch.sims.gol import GoLExperiment
    from rustexp_tpu_torch.sims.nbody import NBodyExperiment, stable_orbits
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
    names = ("raster_queue", "raster_bins", "raster_shade", "gol_swar",
             "gol_stencil", "nbody_forces", "sort_radix")
    with ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(load_kernel_lib, names))
    for lib in libs:
        print(f"built {lib.path.name} in {lib.build_seconds:.2f} s [{card}]",
              flush=True)
    print(f"all kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"[{card}]", flush=True)
    for lib in libs:
        # B1 and B7, B2 and B3, S, B4, B5, B8
        if lib.name in ("raster_queue", "raster_bins", "raster_shade",
                        "gol_swar", "nbody_forces", "gol_stencil"):
            for line in ptxas_summary(lib.ptxas):
                print(f"ptxas {lib.name} {line}", flush=True)

    # Phase 3: each kernel against its plain version, on the card.
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase:.1f} s [{card}]", flush=True)
        t_phase = now

    cmp1 = b1_vs_plain(dev, pp, rq, meshes, cubemap, camera)
    stress_bad = b1_stress(dev, rq)
    if stress_bad:
        return fail(f"B1 on the stress queue: {stress_bad} mismatching words")
    cmp2 = b2_vs_plain(dev, pp, rb, setup_triangles, meshes, cubemap, camera)
    cmp3 = b3_vs_plain(dev, pp, rb, setup_triangles, meshes, cubemap, camera)
    stress_bad = b3_stress(dev, rb)
    if stress_bad:
        return fail(f"B3 on the stress bins: {stress_bad} mismatching words")
    cmp7 = b7_vs_plain(dev, pp, rq, meshes, cubemap, camera)
    stress_bad = b7_stress(dev, rq)
    if stress_bad:
        return fail(f"B7 on the stress queue: {stress_bad} mismatching words")
    phase_done("B1, B2, B3, B7 against their plain versions")
    cmpS = s_vs_plain(dev, bench, sd)
    for label, r in cmpS.items():
        if r["bad"] or r["covered"] == 0 or r["launches_per_call"] != 1:
            return fail(f"S {label}: {r['bad']} mismatching words, "
                        f"{r['covered']} covered pixels, "
                        f"{r['launches_per_call']} grid launches a call")
    phase_done("S against its plain version")
    msg, more1, more7 = kernels_on_orders(dev, card, pp, rq, bench, meshes,
                                          cubemap)
    if msg:
        return fail(msg)
    cmp1.update(more1)
    cmp7.update(more7)
    phase_done("B1 and B7 on the plane and direct queues")
    for kernel, cmp in (("B1", cmp1), ("B2", cmp2), ("B3", cmp3),
                        ("B7", cmp7)):
        for label, r in cmp.items():
            if r["bad"] or r["covered"] == 0:
                return fail(f"{kernel} {label}: {r['bad']} mismatching "
                            f"words, {r['covered']} covered pixels")
    cmp4 = b4_vs_plain(dev, gb)
    cmp8 = b8_vs_plain(dev, gs)
    cmp6 = b6_vs_plain(dev, sb, bh, stable_orbits)
    cmp5 = b5_vs_plain(dev, npl, stable_orbits)
    for kernel, cmp in (("B4", cmp4), ("B8", cmp8), ("B6", cmp6),
                        ("B5", cmp5)):
        for label, r in cmp.items():
            if r["bad"]:
                return fail(f"{kernel} {label}: disagrees with its plain "
                            f"version ({r['bad']})")

    phase_done("B4, B8, B6, B5 against their plain versions")

    # Phase 4: the main paths, each counted on its own.
    counters = {"B1": rq.raster_attrs_queue_cuda,
                "B2": rb.raster_attrs_bins_cuda,
                "B3": rb.raster_gbuffer_bins_cuda,
                "B4": gb.multi_step_packed_cuda,
                "B5": npl.forces_pallas_cuda,
                "B6": sb.sort_kv_cuda,
                "B7": rq.raster_zslot_queue_cuda,
                "B8": gs.multi_step_pallas_cuda,
                "S": sd.shade_pack_cuda}
    path_kernels = {"Killeroo": ("B1",), "Cube": ("B2",)}
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
        msg = shade_per_render(f"the {name} Experiment path", got)
        if msg:
            return fail(msg)
        for k in counters:
            launches[k] += got[k]

    phase_done("the Experiment paths")
    msg, sampled = sampling(dev, card, bench, counters, launches)
    if msg:
        return fail(msg)
    phase_done("run_suite and short batches")

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

    msg, profiles = gbuffer_paths(dev, card, pp, raster_shard, meshes,
                                  cubemap, camera, RasterizerExperiment,
                                  counters, launches)
    if msg:
        return fail(msg)
    phase_done("the Experiment frames against the CPU and the G-buffer "
               "paths")
    msg = moving_paths(dev, card, pp, rq, bench, meshes, cubemap, counters,
                       launches)
    if msg:
        return fail(msg)
    phase_done("the moving camera")
    msg = shader_configs(dev, card, pp, sh, meshes, cubemap, camera)
    if msg:
        return fail(msg)
    phase_done("the 32 shader configurations")
    for msg in (gol_paths(dev, card, GoLExperiment, counters, launches,
                          {"B4": gb._b4_plan(256 // 32, 256, 8).launches,
                           "B8": gs._b8_plan(256, 256, 8).launches}),
                nbody_paths(dev, card, NBodyExperiment, counters, launches,
                            npl._b5_plan(NBODY_N)[1]),
                nbody_card_vs_cpu(dev, NBodyExperiment)):
        if msg:
            return fail(msg)
    phase_done("the GoL and N-body paths")
    msg, seeded = seeded_states(dev, card, gb, sb, bh, npl, GoLExperiment,
                                counters, launches)
    if msg:
        return fail(msg)
    for kernel, cmp in (("B4", cmp4), ("B5", cmp5), ("B6", cmp6)):
        cmp.update(seeded[kernel])
    phase_done("the seeded states")
    records = []
    # each bench makes a warm-up call and BENCH_RUNS timed ones; B4 and B5
    # launch what their plans say, B6 12 times a step
    calls = 1 + BENCH_RUNS
    for label, kernel, expect, run in (
            ("bench_gol 256^2", "B4",
             calls * gb._b4_plan(256 // 32, 256, GOL_BENCH_GENS).launches,
             lambda: bench.bench_gol(GOL_BENCH_GENS, BENCH_RUNS, 256,
                                     device=dev)),
            ("bench_gol 2048^2", "B4",
             calls * gb._b4_plan(2048 // 32, 2048, GOL_BENCH_GENS).launches,
             lambda: bench.bench_gol(GOL_BENCH_GENS, BENCH_RUNS, 2048,
                                     device=dev)),
            ("bench_nbody brute 131072", "B5",
             calls * NBODY_BENCH_STEPS["pallas"] * npl._b5_plan(NBODY_N)[1],
             lambda: bench.bench_nbody(NBODY_N, NBODY_BENCH_STEPS["pallas"],
                                       BENCH_RUNS, "pallas", True,
                                       device=dev)),
            ("bench_nbody bh 131072", "B6",
             calls * NBODY_BENCH_STEPS["bh"] * 12,
             lambda: bench.bench_nbody(NBODY_N, NBODY_BENCH_STEPS["bh"],
                                       BENCH_RUNS, "bh", device=dev))):
        for c in counters.values():
            c.launches = 0
        rec = run()
        got = {k: c.launches for k, c in counters.items()}
        print(f"launches during {label}: {got} ({kernel}: {expect} "
              f"expected, {got[kernel] / calls:g} a call)", flush=True)
        if got[kernel] != expect:
            return fail(f"{label} launched kernel {kernel} {got[kernel]} "
                        f"times, not {expect}")
        if rec.get("finite") is False or rec.get("live_cells") == 0:
            return fail(f"{label}: bad result {rec}")
        for k in counters:
            launches[k] += got[k]
        records.append((label, rec))

    phase_done("the GoL and N-body benches")

    # Phase 5: times, each beside the card's name and power limit.
    for kernel, cmp in (("B1", cmp1), ("B2", cmp2), ("B3", cmp3),
                        ("B7", cmp7)):
        for label, r in cmp.items():
            what = ("all the call's activity" if kernel in ("B1", "B7")
                    else "device")
            print(f"time {kernel} {label} 512x512 ({r['work']}): kernel "
                  f"{r['ms']:.4f} ms ({what}, profiler), wrapper call "
                  f"{r['call_ms']:.4f} ms and plain version "
                  f"{r['plain_ms']:.4f} ms (CUDA events), bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}) [{card}]")
    for label, r in cmpS.items():
        print(f"time S {label} 512x512 ({r['work']}): all the call's "
              f"activity {r['ms']:.4f} ms and the grid alone "
              f"{r['kernel_ms']:.4f} ms (device, profiler), wrapper call "
              f"{r['call_ms']:.4f} ms and plain version {r['plain_ms']:.4f} "
              f"ms (CUDA events), bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms'] * 100:.1f}% of "
              f"the call's activity [{card}]")
    for r in path_profiles(profiles):
        print(f"profile path {r['label']} ({PATH_FRAMES} frames): "
              f"wall {r['wall_ms']:.4f} ms/frame (CUDA events), device busy "
              f"{r['busy_ms']:.4f} ms/frame (profiler, union of the card's "
              f"activities), {r['activities']:.1f} device activities/frame, "
              f"kernel {r['kernel_ms']:.4f} ms/frame; idle share "
              f"{r['idle'] * 100:.1f}% [{card}]")
    for kernel, cmp in (("B4", cmp4), ("B8", cmp8), ("B6", cmp6),
                        ("B5", cmp5)):
        for label, r in cmp.items():
            if "ms" not in r:
                continue  # compared, not timed
            lib = ""
            if "library_ms" in r:
                lib = (f", library {r['library_ms']:.4f} ms (stable "
                       f"torch.sort and 6 gathers, device, profiler; "
                       f"{r['library_event_ms']:.4f} ms by CUDA events), "
                       f"kernel / library {r['ms'] / r['library_ms']:.3f}; "
                       f"kernel by launch "
                       + ", ".join(f"{k} {v:.4f}" for k, v in
                                   sorted(r["parts"].items())) + " ms")
            print(f"time {kernel} {r['work']}: kernel {r['ms']:.4f} ms "
                  f"(device, profiler), wrapper call {r['call_ms']:.4f} ms "
                  f"and plain version {r['plain_ms']:.4f} ms (CUDA "
                  f"events){lib}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}) [{card}]")
    for label, rec in records:
        print(f"bench {label} {json.dumps(rec)} [{card}]")
    for r in bench_profiles(dev, records, gb, bh, npl, stable_orbits):
        print(f"profile bench {r['label']}: device busy {r['busy_ms']:.6f} "
              f"ms/{r['unit']} (profiler, union of the card's activities), "
              f"{r['activities']:.3f} device activities/{r['unit']}; idle "
              f"share {r['idle'] * 100:.1f}% of the bench median "
              f"{r['wall_ms']:.6f} ms/{r['unit']} [{card}]")
    phase_done("the profiles")
    with tempfile.TemporaryDirectory() as tmp:
        msg = app_shell(dev, card, counters, launches, tmp)
    if msg:
        return fail(msg)
    phase_done("the app shell")
    with tempfile.TemporaryDirectory() as tmp:
        msg = sharded_paths(dev, card, launches, tmp)
    if msg:
        return fail(msg)
    phase_done("sharded paths")
    msg, scenes = surfaces(dev, card, counters, launches)
    if msg:
        return fail(msg)
    phase_done("the surfaces (bench and graft_entry)")
    k = bench.FRAMES_PER_DISPATCH
    for label, r in scenes.items():
        print(f"time frame {label} 512x512 (the bench's bench_scene, a "
              f"fresh process, CUDA events, {r['n_runs']} runs x {k} "
              f"frames): best {r['us'] / 1e3:.4f} ms, "
              f"median {r['us_median'] / 1e3:.4f} ms, spread "
              f"{r['spread_pct']:.1f}% [{card}]")
    for label, forms in sampled.items():
        here, short, fresh = (forms["bench_scene"], forms["short"],
                              scenes[label])
        print(f"sampling {label}: this process over the bench's fresh "
              f"process, bench_scene best x"
              f"{here['best'] * 1e6 / fresh['us']:.3f} and median x"
              f"{here['median'] * 1e6 / fresh['us_median']:.3f}, short "
              f"batches best x{short['best'] * 1e6 / fresh['us']:.3f} and "
              f"median x{short['median'] * 1e6 / fresh['us_median']:.3f} "
              f"[{card}]")
    for r in frame_breakdowns(bench):
        print(f"profile frame {r['scene']} 512x512 ({r['backend']}, "
              f"{PROFILE_FRAMES} frames): device busy {r['busy_ms']:.4f} "
              f"ms/frame (profiler, union of the card's activities), "
              f"{r['activities']:.1f} device activities/frame, raster "
              f"kernel {r['raster_ms']:.4f} ms/frame; idle share "
              f"{r['idle'] * 100:.1f}% of the unprofiled median "
              f"{r['wall_ms']:.4f} ms/frame ({WALL_RUNS} runs x "
              f"{PROFILE_FRAMES} frames, CUDA events) [{card}]")
    phase_done("the frame profiles")

    def entry(name, source, replaces, kernel, cmp, label, *more):
        r = cmp[label]
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[kernel],
             "max_abs_err": max(c["err"] for c in cmp.values()),
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r.get("library_ms")}
        if more:  # the same numbers at other shapes of the main path
            e["also"] = {m: {k: cmp[m][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by")}
                         for m in more}
        return e

    print(f"profiler sessions lost {lost_pads[0]} of their opening and "
          f"{lost_pads[1]} of their closing pad records; {lost_sessions} "
          f"sessions were thrown away and run again; the longest wait a "
          f"kept session had was {most_settle:.2f} s [{card}]")
    print(card)
    print(json.dumps({"kernels": [
        entry("queue_raster (B1)", "rustexp_tpu_torch/csrc/raster_queue.cu",
              "rustexp_tpu/ops/raster_queue.py:690", "B1", cmp1, "KillerooP",
              "TorusKnotP", *(f"{label} {order} (moving)"
                              for label, _, order in MOVING_SCENES)),
        entry("bins_raster (B2)", "rustexp_tpu_torch/csrc/raster_bins.cu",
              "rustexp_tpu/ops/raster_pallas.py:338", "B2", cmp2, "CubeP"),
        entry("bins_gbuffer (B3)", "rustexp_tpu_torch/csrc/raster_bins.cu",
              "rustexp_tpu/ops/raster_pallas.py:138", "B3", cmp3,
              "Killeroo"),
        entry("gol_swar (B4)", "rustexp_tpu_torch/csrc/gol_swar.cu",
              "rustexp_tpu/ops/gol_bits.py:113", "B4", cmp4,
              "2048x2048 tiled"),
        entry("nbody_forces (B5)", "rustexp_tpu_torch/csrc/nbody_forces.cu",
              "rustexp_tpu/ops/nbody_pallas.py:38", "B5", cmp5,
              (NBODY_N, True)),
        entry("sort_radix (B6)", "rustexp_tpu_torch/csrc/sort_radix.cu",
              "rustexp_tpu/ops/sort_bitonic.py:125", "B6", cmp6,
              "morton 131072"),
        entry("queue_zslot (B7)", "rustexp_tpu_torch/csrc/raster_queue.cu",
              "rustexp_tpu/ops/raster_queue.py:799", "B7", cmp7,
              "KillerooP", "KillerooP plane (moving)"),
        entry("gol_stencil (B8)", "rustexp_tpu_torch/csrc/gol_stencil.cu",
              "rustexp_tpu/ops/gol_stencil.py:99", "B8", cmp8,
              GOL_EXPERIMENT_B8, "512x512 x20"),
        entry("shade_pack (S)", "rustexp_tpu_torch/csrc/raster_shade.cu",
              "no kernel: plain jnp (rustexp_tpu/raster/pipeline.py:661)",
              "S", cmpS, "KillerooP", "CubeP"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

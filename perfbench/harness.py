"""One run of one cell: set-up, the measured window, the check, the line.

The traffic is a data file (perfbench/traffic/<name>.json) that this one
generator reads: the entry it feeds (``entry``), the tick of frame i,
``(t0 + i * frame_step) / fps`` with ``t0 = seed % start_frames`` (0 when
``start_frames`` is 0), the frames warmed up in set-up, how many frames
the check samples, whether every frame must be the same, and how a
``--trace 1`` run divides its window. Frames run back to back in one
closed loop, one client, in the order the entry fixes. A frame is one
call of the entry's ``frame(tick)``: a rendered picture, or one step of
a simulation. What decides ``correct`` is the configuration's own check,
perfbench/checks/<check>.py; the harness never looks inside a frame's
output.
"""

from __future__ import annotations

import gc
import json
import random
import subprocess
import sys
import time
import warnings

import torch

from . import profiling, stats

FORBIDDEN = ("jax", "jaxlib", "flax", "rustexp_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (the port's own name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Ticks:
    def __init__(self, traffic: dict, seed: int):
        mod = traffic["start_frames"]
        self.t0 = seed % mod if mod else 0
        self.step = traffic["frame_step"]
        self.fps = traffic["fps"]

    def __call__(self, i: int) -> float:
        return (self.t0 + i * self.step) / self.fps


class Marks:
    """A completion mark after each frame: a CUDA event recorded on the
    stream after the frame's last operation (no synchronize), or the host
    clock on the CPU (tests only)."""

    def __init__(self, device: torch.device, expect: int):
        self.cuda = device.type == "cuda"
        self.pool = [self._new() for _ in range(expect)] if self.cuda else []
        self.used = 0
        self.times = []

    def _new(self):
        return torch.cuda.Event(enable_timing=True)

    def mark(self) -> None:
        if not self.cuda:
            self.times.append(time.perf_counter() * 1e3)
            return
        if self.used == len(self.pool):
            self.pool += [self._new() for _ in range(1000)]
        self.pool[self.used].record()
        self.used += 1

    def intervals_ms(self) -> list[float]:
        if not self.cuda:
            return [b - a for a, b in zip(self.times, self.times[1:])]
        ev = self.pool[:self.used]
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


class Sample:
    """A uniform sample of `k` frames of the window, drawn from the seed
    (reservoir sampling): each kept frame's index, tick and output."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), [], 0

    def offer(self, i: int, tick: float, output) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, tick, output))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (i, tick, output)
        self.seen += 1


class Window:
    """Drives frames and keeps what the check and the metrics need."""

    def __init__(self, drv, ticks: Ticks, traffic: dict, seed: int,
                 device: torch.device, expect: int):
        self.drv, self.ticks, self.dev = drv, ticks, device
        # read by the raster check; None where the entry has none
        self.show_cm = getattr(drv, "show_cm", None)
        self.launches = getattr(drv, "launches", None)
        self.unlaunched = 0  # frames in which none of the cell's kernels ran
        self.same = traffic["identical_frames"]
        self.sample = Sample(traffic["sample_frames"], seed)
        self.marks = Marks(device, expect)
        self.sums = []
        self.held = []
        self.flags = torch.zeros((), dtype=torch.int64, device=device)
        self.has_flag = False
        self.n = 0          # frames run since set-up ended
        self.first = 0      # frame index of the set-up's end

    def frame(self, mark: bool = True, hold: bool = False) -> None:
        """Run the next frame. `hold` keeps its checksum and flag ops
        off the card until release(), so a profiled frame holds the
        program's work alone."""
        i = self.first + self.n
        tick = self.ticks(i)
        before = self.launches() if self.launches else 0
        output, flag = self.drv.frame(tick)
        if self.launches and self.launches() == before:
            self.unlaunched += 1
        if hold:
            self.held.append((output, flag))
        else:
            self._tally(output, flag)
        if mark:
            self.marks.mark()
        self.sample.offer(i, tick, output)
        self.n += 1

    def _tally(self, output, flag) -> None:
        if flag is not None:
            self.flags = self.flags + flag
            self.has_flag = True
        if self.same:
            self.sums.append(output.view(torch.int32).sum(dtype=torch.int64))

    def release(self) -> None:
        for output, flag in self.held:
            self._tally(output, flag)
        self.held = []

    def run_for(self, seconds: float, mark: bool = True) -> tuple[int, float]:
        """Frames until `seconds` have passed, then a synchronize ->
        (frames, wall seconds)."""
        n0 = self.n
        t0 = time.perf_counter()
        if mark:
            self.marks.mark()
        while time.perf_counter() - t0 < seconds:
            self.frame(mark)
        sync(self.dev)
        return self.n - n0, time.perf_counter() - t0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


class TraceData:
    """What a per-layer metric reader reads from a --trace 1 run."""

    def __init__(self, cell, session, wall_ms_per_frame, syncs, sync_frames,
                 rerenders, frames, profiled_ticks, device):
        self.cell = cell
        self.session = session
        self.wall_ms_per_frame = wall_ms_per_frame
        self.syncs, self.sync_frames = syncs, sync_frames
        self.rerenders = rerenders
        self.frames = frames
        self.profiled_ticks = profiled_ticks
        self.device = device


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, entry=None,
             out=None, err=None) -> int:
    """Set up, run the window, check, print the result line; -> exit code.
    `entry` replaces the traffic's entry (the control and fault tests)."""
    out = out or sys.stdout
    err = err or sys.stderr
    traffic = cell.traffic
    check = cell.check()
    ticks = Ticks(traffic, seed)
    drv = entry if entry is not None else cell.entry().Entry(
        cell.config, traffic, device, seed=seed)
    for i in range(traffic["warmup_frames"]):
        drv.frame(ticks(i))
    sync(device)
    win = Window(drv, ticks, traffic, seed, device,
                 expect=max(1000, int(seconds * 500)))
    win.first = traffic["warmup_frames"]
    setup_s = time.perf_counter() - t_start

    metrics, dev_extra, breakdown, data = {}, {}, None, None
    if not trace:
        n, wall = win.run_for(seconds)
        iv = win.marks.intervals_ms()
        metrics["frame_ms"] = wall / n * 1e3
        metrics["frame_p95_ms"] = stats.percentile(iv, 95)
        metrics["setup_s"] = setup_s
        half = len(iv) // 2
        med = stats.percentile(iv, 50)
        print(f"window: {n} frames in {wall:.4f} s; ms a frame by halves "
              f"{sum(iv[:half]) / max(half, 1):.4f}, "
              f"{sum(iv[half:]) / max(len(iv) - half, 1):.4f}; intervals "
              f"q1 {stats.percentile(iv, 25):.4f} median {med:.4f} q3 "
              f"{stats.percentile(iv, 75):.4f} p99 "
              f"{stats.percentile(iv, 99):.4f} max {max(iv):.4f}, "
              f"{sum(v > 3 * med for v in iv)} over 3x the median",
              file=err)
    else:
        tr = traffic["trace"]
        n_a, wall_a = win.run_for(seconds * tr["unprofiled_share"],
                                  mark=False)
        drv.start_counting()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            for _ in range(tr["sync_frames"]):
                win.frame(mark=False)
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        sync(device)
        first_profiled = win.first + win.n
        session = profiling.profile_frames(
            lambda: win.frame(mark=False, hold=True), tr["profile_frames"])
        win.release()
        done = win.first + win.n
        profiled = [ticks(i) for i in range(done - session.frames, done)]
        rerenders = drv.stop_counting()
        counted = done - (first_profiled - tr["sync_frames"])
        data = TraceData(cell, session, wall_a / n_a * 1e3, syncs,
                         tr["sync_frames"], rerenders, counted, profiled,
                         device)
        dev_extra = {"busy_s": session.busy_s(), "window_s": session.wall_s}
        breakdown = {"device_ops": session.top_ops(),
                     "idle_gaps": session.idle_gaps()}
        print(f"traced: {n_a} unprofiled frames in {wall_a:.4f} s; "
              f"{tr['sync_frames']} frames under the sync debug mode, "
              f"{syncs} synchronizing calls; {session.frames} profiled "
              f"frames, {len(session.device)} device activities, "
              f"{session.lost_sessions} sessions thrown away; "
              f"re-renders {rerenders} of {counted} frames; card "
              f"{power_limit()}", file=err)

    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=err)
        return 3
    attempted = win.n
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    drv.close()
    win.drv = drv = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if data is not None:  # read after the peak: the roofline's set-up
        for m in cell.per_layer:  # runs the reference on the card
            v = cell.metric_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = v
    checks, failed, lines = check.check(cell, win, device)
    correct = all(v <= lim for v, lim in checks.values())
    units = {m["name"]: m["unit"]
             for m in cell.end_to_end + cell.per_layer}
    line = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in metrics.items()},
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": peak,
                   **dev_extra},
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for text in lines:
        print(text, file=err)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=err)
    err.flush()
    if forbidden_modules():
        return 3
    print(json.dumps(line), file=out, flush=True)
    return 0

"""The card's activities under torch.profiler, with pads and retries.

A frozen copy of the method that has read the H100 since the port's first
profiles: the card's timestamps drift against the host's clock by
milliseconds and the profiler drops every record outside the session's
window, so a session now and then loses the card's records at its start,
sometimes all of them, while it keeps every launch call on the host. So a
session waits on the host after it opens and before it closes and puts
PADS short spin kernels, each set followed by a synchronize, before and
after the work. A pad kept on each side shows that no loss reached the
work. A session without both is thrown away and run again, up to TRIES
sessions; the wait doubles after a lost session and halves after a kept
one. A run whose sessions all lose their records raises: a lost record
is never read as an idle card.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import stats

PADS = 4
TRIES = 12
SETTLE_S = 0.02
SETTLE_MAX_S = 6.4
NAME_CHARS = 120


@dataclass
class Session:
    """The kept session: the card's work activities, the host's events,
    the frames in it and their wall seconds, and the sessions lost."""

    device: list
    host: list
    frames: int
    wall_s: float
    lost_sessions: int = 0
    lost_pads: list = field(default_factory=lambda: [0, 0])

    def busy_s(self) -> float:
        return stats.union_length(
            (e.time_range.start, e.time_range.end) for e in self.device) / 1e6

    def kernel_s(self, names) -> tuple[float, int]:
        """Seconds and count of the activities whose name holds one of
        `names`."""
        hit = [e for e in self.device if any(n in e.name for n in names)]
        return (sum(e.time_range.end - e.time_range.start for e in hit) / 1e6,
                len(hit))

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for e in self.device:
            by[e.name[:NAME_CHARS]] += (e.time_range.end
                                        - e.time_range.start) / 1e6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The card's idle stretches, summed by the host call that
        launched the activity ending each one (the torch op around its
        CUDA runtime call, matched by correlation id; the runtime call
        itself where no torch op encloses it, as for a ctypes launch):
        what the card waited for."""
        launcher = {}
        for e in self.host:
            if e.name.startswith("cuda"):
                parent = getattr(e, "cpu_parent", None)
                launcher[e.id] = parent.name if parent is not None \
                    else e.name
        acts = sorted(self.device, key=lambda e: e.time_range.start)
        by = defaultdict(float)
        for s, e, i in stats.gaps(
                (a.time_range.start, a.time_range.end) for a in acts):
            name = launcher.get(acts[i].id, "launch not recorded")
            by[name[:NAME_CHARS]] += (e - s) / 1e6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]


def profile_frames(fn, frames: int) -> Session:
    """Profile `frames` calls of fn() (each renders the next frame) with
    CPU and CUDA activities; returns the first session that kept a pad
    on each side. Prints the sessions thrown away to stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pads():
        for _ in range(PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    settle, lost, lost_pads = SETTLE_S, 0, [0, 0]
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            pads()
            t0 = time.perf_counter()
            for _ in range(frames):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pads()
            time.sleep(settle)
        events = list(prof.events())
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        spins = [e.time_range.start for e in dev if "spin_kernel" in e.name]
        work = [e for e in dev if "spin_kernel" not in e.name]
        starts = [e.time_range.start for e in work] or [0.0]
        kept = (sum(t < min(starts) for t in spins),
                sum(t > max(starts) for t in spins))
        for side in (0, 1):
            lost_pads[side] += PADS - kept[side]
        if work and all(kept):
            if lost:
                print(f"profiler: {lost} sessions thrown away (lost "
                      f"records), pads lost {lost_pads}", file=sys.stderr)
            host = [e for e in events if e.device_type == DeviceType.CPU]
            return Session(work, host, frames, wall, lost, lost_pads)
        lost += 1
        settle = min(2 * settle, SETTLE_MAX_S)
        print(f"profiler: session {lost} lost its records (pads kept "
              f"{kept}); trying again", file=sys.stderr)
    raise RuntimeError(f"{TRIES} profiling sessions in a row lost their "
                       f"records; no device metric is reported")

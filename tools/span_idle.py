"""The card's idle time put down to the program's spans, on the card.

    python3 tools/span_idle.py --workload <cell> --seed <n>
                               [--seconds 10] [--frames 20]

from the root of a checkout. Drives one benchmark cell as
perfbench/harness.py does (its entry, traffic and warm-up), runs it
unprofiled for --seconds, then profiles --frames frames with
perfbench/profiling.py (CPU and CUDA activities, pads and retries), and
prints one JSON line:

- ``wall_ms``: wall ms a frame unprofiled and profiled, and ``stretch``,
  their ratio (what the profiler adds to a frame);
- ``busy_ms``, ``idle_ms``: the union of the card's activities and the
  idle gaps between them, per profiled frame;
- ``idle_ms_by_span``: those gaps summed by the innermost program span
  (rustexp_tpu_torch/core/trace.py) open when the activity that ends each
  gap was launched. The activity's correlation id names the CUDA runtime
  call that launched it; its chain of ``cpu_parent`` host events is
  walked up to the first span. "no span" where none encloses the launch,
  "launch not recorded" where no runtime call has that id;
- ``spans``: each span's calls and host ms per frame, unprofiled.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def idle_by_span(device, host, names) -> dict[str, float]:
    """{innermost span: idle seconds} of the gaps between the `device`
    activities, each put down to the span in `names` that encloses the
    host runtime call (a `host` event named cuda*) of the same id as the
    activity ending the gap."""
    from perfbench import stats

    launcher = {e.id: e for e in host if e.name.startswith("cuda")}
    acts = sorted(device, key=lambda e: e.time_range.start)
    by = defaultdict(float)
    for s, e, i in stats.gaps(
            (a.time_range.start, a.time_range.end) for a in acts):
        call = launcher.get(acts[i].id)
        if call is None:
            name = "launch not recorded"
        else:
            p = call.cpu_parent
            while p is not None and p.name not in names:
                p = p.cpu_parent
            name = "no span" if p is None else p.name
        by[name] += (e - s) / 1e6
    return dict(by)


def per_frame(totals: dict, frames: int) -> dict:
    return {k: {"calls": c / frames, "host_ms": ns / 1e6 / frames}
            for k, (c, ns) in sorted(totals.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness, profiling, spec, stats
    from rustexp_tpu_torch.core import trace

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    traffic = cell.traffic
    ticks = harness.Ticks(traffic, args.seed)
    drv = cell.entry().Entry(cell.config, traffic, dev)
    for i in range(traffic["warmup_frames"]):
        drv.frame(ticks(i))
    harness.sync(dev)
    win = harness.Window(drv, ticks, traffic, args.seed, dev, expect=1000)
    win.first = traffic["warmup_frames"]

    trace.reset_spans()
    n, wall = win.run_for(args.seconds, mark=False)
    spans = per_frame(trace.span_totals(), n)
    session = profiling.profile_frames(
        lambda: win.frame(mark=False, hold=True), args.frames)
    win.release()
    names = set(trace.span_totals())
    f = session.frames
    idle = idle_by_span(session.device, session.host, names)
    gaps = stats.gaps((a.time_range.start, a.time_range.end)
                      for a in session.device)
    line = {
        "workload": args.workload, "seed": args.seed,
        "card": harness.power_limit(),
        "frames": {"unprofiled": n, "profiled": f},
        "wall_ms": {"unprofiled": wall / n * 1e3,
                    "profiled": session.wall_s / f * 1e3},
        "stretch": (session.wall_s / f) / (wall / n),
        "busy_ms": session.busy_s() * 1e3 / f,
        "idle_ms": sum(e - s for s, e, _ in gaps) / 1e3 / f,
        "idle_ms_by_span": {k: v * 1e3 / f for k, v in
                            sorted(idle.items(), key=lambda x: -x[1])},
        "lost_sessions": session.lost_sessions,
        "spans": spans,
    }
    drv.close()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

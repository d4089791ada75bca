"""How often torch.profiler loses the card's activity records.

    python3 -m rustexp_tpu_torch.app.profiler_loss [ROUNDS]
    TEARDOWN_CUPTI=0 python3 -m rustexp_tpu_torch.app.profiler_loss [ROUNDS]

Each round runs 300 unprofiled kernels before each of three profiling
sessions (CUDA activities only), each of which opens with PADS spin kernels
of growing length and a synchronize, then times WORK small kernels. The
first session kind uses short pads (1,000 cycles times the pad's rank),
the second long ones (100,000), the third short ones after the host waits
20 ms, as `chip_smoke.py`'s sessions do. A session's missing pads, work
and host launch calls are printed, with where its first kept launch call
and kernel start (every 50th round's too, whole or not): the card's
timestamps against the host's. Then the totals per kind: whether a
session that keeps a pad can still have lost work is what
`chip_smoke.py`'s retry rule rests on. Last, the host microseconds per
launch of a one-element add, unprofiled, after all the sessions. By
default the profiler tears CUPTI down after each session;
TEARDOWN_CUPTI=0 keeps it up, and the totals name the setting.
Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

PADS = 8
WORK = 50
LAUNCHES = 2000  # unprofiled launches timed after the sessions
# session kinds: (pad base cycles, host wait in s after the session opens)
KINDS = {"short": (1000, 0.0), "long": (100_000, 0.0),
         "settled": (1000, 0.02)}


def session(base_cycles: int, wait: float, x: torch.Tensor) -> dict:
    """What one profiling session kept: its pads and work kernels, the
    host's kernel-launch calls (PADS + WORK were made), and the start of
    the first kept launch call and of the first kept kernel, in us from
    the session's start (None where none was kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(wait)
        for i in range(PADS):
            torch.cuda._sleep(base_cycles * (i + 1))
        torch.cuda.synchronize()
        for _ in range(WORK):
            x.add_(1.0)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    calls = [e for e in events if e.device_type == DeviceType.CPU
             and "LaunchKernel" in e.name]
    pads = sum("spin_kernel" in e.name for e in kernels)
    first = lambda ev: min((e.time_range.start for e in ev), default=None)
    return dict(pads=pads, work=len(kernels) - pads, calls=len(calls),
                first_call_us=first(calls), first_kernel_us=first(kernels))


def main(rounds: int) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    x = torch.zeros(1 << 20, device="cuda")
    y = torch.ones(2048, 2048, device="cuda")
    totals = {k: dict(sessions=0, pads_lost=0, no_pad=0, work_lost=0,
                      work_lost_with_a_pad=0, calls_lost=0) for k in KINDS}
    t0 = time.perf_counter()
    for r in range(rounds):
        for kind, (cycles, wait) in KINDS.items():
            for _ in range(300):
                y.mul_(1.0)
            got = session(cycles, wait, x)
            pads, work = got["pads"], got["work"]
            t = totals[kind]
            t["sessions"] += 1
            t["pads_lost"] += PADS - pads
            t["no_pad"] += pads == 0
            t["work_lost"] += work < WORK
            t["work_lost_with_a_pad"] += pads > 0 and work < WORK
            t["calls_lost"] += PADS + WORK - got["calls"]
            if pads < PADS or work < WORK or got["calls"] < PADS + WORK:
                print(f"round {r} {kind}: kept {pads}/{PADS} pads, "
                      f"{work}/{WORK} work kernels, {got['calls']}/"
                      f"{PADS + WORK} launch calls; first call at "
                      f"{got['first_call_us']} us, first kernel at "
                      f"{got['first_kernel_us']} us", flush=True)
            elif r % 50 == 0:
                print(f"round {r} {kind}: all kept; first call at "
                      f"{got['first_call_us']} us, first kernel at "
                      f"{got['first_kernel_us']} us", flush=True)
    seconds = time.perf_counter() - t0
    one = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(LAUNCHES):
        one.add_(1.0)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t1) / LAUNCHES * 1e6
    print(json.dumps(dict(totals=totals, pads=PADS, work=WORK,
                          seconds=seconds, launch_us=launch_us,
                          teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
                          torch=torch.__version__,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 400))

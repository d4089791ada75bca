"""How often torch.profiler loses the card's activity records.

    python3 -m rustexp_tpu_torch.app.profiler_loss [ROUNDS]

Each round runs 300 unprofiled kernels, then two profiling sessions (CUDA
activities only), each of which opens with PADS spin kernels of growing
length and a synchronize, then times WORK small kernels. The first session
kind uses short pads (1,000 cycles times the pad's rank), the second long
ones (100,000). A session's missing pads and missing work are printed,
then the totals per kind: whether a session that keeps a pad can still
have lost work is what `chip_smoke.py`'s retry rule rests on. Needs a
CUDA device; exits 1 without one.
"""

from __future__ import annotations

import json
import sys
import time

import torch

PADS = 8
WORK = 50
BASE_CYCLES = {"short": 1000, "long": 100_000}


def session(base_cycles: int, x: torch.Tensor) -> tuple[int, int]:
    """(pads kept, work kernels kept) of one profiling session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(PADS):
            torch.cuda._sleep(base_cycles * (i + 1))
        torch.cuda.synchronize()
        for _ in range(WORK):
            x.add_(1.0)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    pads = sum("spin_kernel" in e.name for e in events)
    return pads, len(events) - pads


def main(rounds: int) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    x = torch.zeros(1 << 20, device="cuda")
    y = torch.ones(2048, 2048, device="cuda")
    totals = {k: dict(sessions=0, pads_lost=0, no_pad=0, work_lost=0,
                      work_lost_with_a_pad=0) for k in BASE_CYCLES}
    t0 = time.perf_counter()
    for r in range(rounds):
        for kind, cycles in BASE_CYCLES.items():
            for _ in range(300):
                y.mul_(1.0)
            pads, work = session(cycles, x)
            t = totals[kind]
            t["sessions"] += 1
            t["pads_lost"] += PADS - pads
            t["no_pad"] += pads == 0
            t["work_lost"] += work < WORK
            t["work_lost_with_a_pad"] += pads > 0 and work < WORK
            if pads < PADS or work < WORK:
                print(f"round {r} {kind}: kept {pads}/{PADS} pads, "
                      f"{work}/{WORK} work kernels", flush=True)
    print(json.dumps(dict(totals=totals, pads=PADS, work=WORK,
                          seconds=time.perf_counter() - t0,
                          torch=torch.__version__,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 400))

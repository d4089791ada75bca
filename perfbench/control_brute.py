"""The all-pairs N-body check's controls: other steps in the program's
place.

    python3 -m perfbench.control_brute --workload <cell> --seeds 1 2 3
                                       [--seconds 2] [--controls bf16 bh]

runs an all-pairs N-body cell's window with a control step as the system
under test and prints each seed's result line for each control: its
comparison numbers are the control's readings.

* ``bf16``: the plain reference (perfbench/reference/nbody_brute.py)
  with every float op in bfloat16, the nearest precision below the
  configuration's float32; the check has to refuse it;
* ``bh``: float32, but the field of the block Barnes-Hut reference
  (perfbench/reference/nbody.py: Morton order, blocks of 256, 27 near
  blocks, the other blocks' monopoles) put back into the state's order,
  then the same Euler step and no kill, so that only the approximation
  parts it from the all-pairs step; the check has to refuse it;
* ``approx``: the program's own step with kernel B5's approximate
  reciprocal (``rcp.approx.ftz``), about one float32 rounding a term off
  the exact one. Its readings are recorded; no limit has to refuse it.

The first two step the reference's own stable orbits, drawn from the
seed, and import nothing of the program; the third steps the program's
state and imports it. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from perfbench import harness, spec
from perfbench.entries.common import NoRerenders
from perfbench.reference import nbody, nbody_brute

BH_BLOCK, BH_K_NEAR = 256, 27
CONTROLS = ("bf16", "bh", "approx")


def bh_accel(px, py, m, block: int = BH_BLOCK, k_near: int = BH_K_NEAR):
    """(ax, ay) [n] in the state's order: the block Barnes-Hut reference
    field of the bodies in Morton order, put back."""
    order = torch.argsort(nbody.morton_codes(px, py), stable=True)
    sx, sy = nbody.accel_bh(px[order], py[order], m[order], block, k_near)
    ax, ay = torch.empty_like(sx), torch.empty_like(sy)
    ax[order], ay[order] = sx, sy
    return ax, ay


def bh_step(px, py, vx, vy, m, dt: float, block: int = BH_BLOCK,
            k_near: int = BH_K_NEAR):
    """The all-pairs step with the block Barnes-Hut field in its place."""
    ax, ay = bh_accel(px, py, m, block, k_near)
    return (*nbody_brute.euler(px, py, vx, vy, m, ax, ay, dt), m)


class ControlEntry(NoRerenders):
    """Steps its state with the reference in the control's form."""

    def __init__(self, cfg: dict, state, control: str):
        self.state, self.dt = state, cfg["dt"]
        self.control = control

    def frame(self, tick: float):
        before = self.state
        if self.control == "bf16":
            self.state = nbody_brute.step(*before, dt=self.dt,
                                          dtype=torch.bfloat16)
        else:
            self.state = bh_step(*before, dt=self.dt)
        return (before, self.state), None


class ApproxEntry(NoRerenders):
    """The program's state, stepped by its own brute step with B5's
    approximate reciprocal."""

    def __init__(self, cell, device, seed: int):
        self.inner = cell.entry().Entry(cell.config, cell.traffic, device,
                                        seed=seed)
        self.launches = self.inner.launches
        self.dt = cell.config["dt"]

    def frame(self, tick: float):
        from rustexp_tpu_torch.ops import nbody_pallas

        s = self.inner.state
        before = (s.px, s.py, s.vx, s.vy, s.m)
        after = nbody_pallas.step_brute_pallas(*before, 1024, True, self.dt)
        s.px, s.py, s.vx, s.vy = after
        return (before, (*after, s.m)), None

    def close(self) -> None:
        self.inner.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", nargs="+", choices=CONTROLS,
                    default=["bf16", "bh"])
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = cell.config
    for seed in args.seeds:
        for control in args.controls:
            print(f"control {control}, seed {seed}", file=sys.stderr)
            if control == "approx":
                drv = ApproxEntry(cell, dev, seed)
            else:
                state = nbody.stable_orbits(cfg["n"], cfg["rmin"],
                                            cfg["rmax"], seed, dev)
                drv = ControlEntry(cfg, state, control)
            rc = harness.run_cell(cell, seed, args.seconds, False, dev,
                                  time.perf_counter(), entry=drv)
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

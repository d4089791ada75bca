"""The Game of Life check's controls: other steps in the program's place.

    python3 -m perfbench.control_gol [--workload gol.2048] [--seeds 1 2 3]
                                     [--seconds 2]
                                     [--controls stale short highlife no_wrap]

runs a Game of Life cell's window with a control step as the system
under test and prints each seed's result line for each control: its
comparison numbers are the control's readings. Each steps a random soup
of the configuration's size and density, drawn from the seed with
torch's own generator and drawn again at the traffic's reseed cadence,
and each has to read ``correct`` false:

* ``stale``: the step returns its input;
* ``short``: the reference's step with one generation fewer;
* ``highlife``: the rule B36/S23 (a dead cell with six live neighbours
  is born too) in place of B3/S23;
* ``no_wrap``: the reference's rule with dead cells beyond the edges in
  place of the torus.

They import nothing of the program. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from perfbench import harness, spec
from perfbench.entries.common import NoRerenders
from perfbench.reference import gol

CONTROLS = ("stale", "short", "highlife", "no_wrap")


def highlife(grid: torch.Tensor) -> torch.Tensor:
    """One generation of B36/S23 on the torus."""
    nb = gol.neighbours(grid)
    alive = grid == 1
    born = (nb == 3) | (nb == 6)
    return ((~alive & born) | (alive & ((nb == 2) | (nb == 3)))).to(
        torch.uint8)


def no_wrap(grid: torch.Tensor) -> torch.Tensor:
    """One generation of B3/S23 with dead cells beyond the edges."""
    n = grid.shape[0]
    padded = F.pad(grid, (1, 1, 1, 1))
    nb = torch.zeros_like(grid)
    for dy, dx in gol.OFFSETS:
        nb += padded[1 + dy:1 + dy + n, 1 + dx:1 + dx + n]
    return ((nb == 3) | ((grid == 1) & (nb == 2))).to(torch.uint8)


def soup(n: int, density: float, gen: torch.Generator, device):
    """A uint8 [n, n] random fill of the given density."""
    return (torch.rand((n, n), generator=gen, device=device)
            < density).to(torch.uint8)


class ControlEntry(NoRerenders):
    """Steps a soup of its own with the control's step."""

    def __init__(self, cfg: dict, traffic: dict, control: str, seed: int,
                 device):
        self.cfg, self.control, self.device = cfg, control, device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.every = traffic["reseed_every"]
        self.steps = 0
        self.grid = None

    def step(self, grid: torch.Tensor) -> torch.Tensor:
        k = self.cfg["steps_per_frame"]
        if self.control == "stale":
            return grid
        if self.control == "short":
            return gol.run(grid, k - 1)
        one = highlife if self.control == "highlife" else no_wrap
        for _ in range(k):
            grid = one(grid)
        return grid

    def frame(self, tick: float):
        if self.steps % self.every == 0:
            self.grid = soup(self.cfg["n"], self.cfg["fill_density"],
                             self.gen, self.device)
        self.steps += 1
        before = self.grid
        self.grid = self.step(before)
        return (before, self.grid), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="gol.2048")
    ap.add_argument("--seeds", type=int, nargs="+", default=[2**31 + 281])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", nargs="+", choices=CONTROLS,
                    default=list(CONTROLS))
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        for control in args.controls:
            print(f"control {control}, seed {seed}", file=sys.stderr)
            drv = ControlEntry(cell.config, cell.traffic, control, seed, dev)
            rc = harness.run_cell(cell, seed, args.seconds, False, dev,
                                  time.perf_counter(), entry=drv)
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

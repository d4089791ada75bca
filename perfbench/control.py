"""The raster check's control: the plain reference in the program's place.

    python3 -m perfbench.control --workload <cell> --seeds 1 2 3
                                 [--seconds 2]

runs a raster cell's window with the reference renderer, computed in the
nearest precision below the configuration's (bfloat16 for float32), as
the system under test, and prints each seed's result line: its
comparison numbers are the control's readings, the upper ends the
limits in the configuration files are set below. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from perfbench import harness, spec
from perfbench.entries.common import NoRerenders
from perfbench.reference import assets, raster


class ControlEntry(NoRerenders):
    """Renders each frame with the reference in bfloat16."""

    def __init__(self, cfg: dict, show_cm: bool, device):
        self.cfg, self.show_cm, self.device = cfg, show_cm, device
        self.mesh = assets.MESHES[cfg["mesh"]]()
        self.cm, self.cross = assets.ENVMAPS[cfg["envmap"]]()

    def frame(self, tick: float):
        cfg = self.cfg
        fb = raster.render(self.mesh, self.cm, self.cross,
                           assets.eye(cfg["camera"], tick),
                           w=cfg["width"], h=cfg["height"],
                           per_pixel=cfg["per_pixel"], shader=cfg["shader"],
                           bg=cfg["background"], show_cm=self.show_cm,
                           device=self.device, dtype=torch.bfloat16)
        return fb.to(torch.int32), None  # the uint32 bits, as int32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    show_cm = cell.entry().Entry.show_cm
    for seed in args.seeds:
        drv = ControlEntry(cell.config, show_cm, dev)
        rc = harness.run_cell(cell, seed, args.seconds, False, dev,
                              time.perf_counter(), entry=drv)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

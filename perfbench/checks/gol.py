"""The check of a Game of Life configuration: each sampled step run again
from the program's grid before it by the plain reference
(perfbench/reference/gol.py), on the card, and the steps that ran no
work. Game of Life is exact arithmetic, so the limits are counts.

* ``cells_off``: the cells of the worst sampled step in which the
  program's grid after the step differs from the reference's
  ``steps_per_frame`` generations of the grid before it. A grid of
  another shape or dtype than the configuration's, or holding a value
  outside {0, 1}, counts every cell.
* ``static_samples``: the sampled steps in which the reference changed
  no cell. Such a step cannot tell a program that returns its input
  from a sound one, so a sound run has none: the traffic's reseed keeps
  the soup live.
* ``steps_not_run``: the frames in which the program launched no kernel
  B4, by the entry's ``launches`` hook.
"""

from __future__ import annotations

import torch

from perfbench.reference import gol

NAMES = ("cells_off", "static_samples")


def valid(cfg: dict, grid) -> bool:
    """Whether `grid` is a uint8 [n, n] tensor of 0s and 1s."""
    n = cfg["n"]
    return (isinstance(grid, torch.Tensor) and grid.dtype == torch.uint8
            and tuple(grid.shape) == (n, n) and bool((grid <= 1).all()))


def compare(cfg: dict, before, after) -> dict[str, int]:
    """The numbers of one step: `before` the program's grid before it,
    `after` its grid after it."""
    n = cfg["n"]
    if not (valid(cfg, before) and valid(cfg, after)):
        return {"cells_off": n * n, "static_samples": 0}
    ref = gol.run(before, cfg["steps_per_frame"])
    return {"cells_off": int((after != ref).sum()),
            "static_samples": int(bool(torch.equal(ref, before)))}


def check(cell, win, device) -> tuple[dict, int, list[str]]:
    """-> ({name: (value, limit)}, frames that failed, lines for stderr)."""
    cfg = cell.config
    limits = cfg["correct_limits"]
    kept = sorted(win.sample.kept, key=lambda s: s[0])
    per_step = [compare(cfg, before, after) for _, _, (before, after) in kept]
    out = {"cells_off": (max((s["cells_off"] for s in per_step), default=0),
                         limits["cells_off"]),
           "static_samples": (sum(s["static_samples"] for s in per_step),
                              limits["static_samples"]),
           "steps_not_run": (win.unlaunched, limits["steps_not_run"])}
    failed = sum(s["cells_off"] > limits["cells_off"] for s in per_step)
    failed += win.unlaunched
    lines = [f"sampled steps {[s[0] for s in kept]}, "
             + "; ".join(f"{k} {[s[k] for s in per_step]}" for k in NAMES)]
    return out, failed, lines

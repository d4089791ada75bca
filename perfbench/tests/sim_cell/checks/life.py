"""The check of a Life configuration: each sampled step recomputed from
its state before by a plain numpy step, and the steps that ran no work.

``cells_off``: the cells of the worst sampled step whose state after
differs from the reference's; ``steps_not_run``: the frames in which the
entry's ``launches`` did not move (a state handed back again)."""

from __future__ import annotations

import numpy as np


def life_step(grid: np.ndarray) -> np.ndarray:
    p = np.pad(grid, 1, mode="wrap").astype(np.int32)
    h, w = grid.shape
    n = sum(p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx)
    return ((n == 3) | ((grid == 1) & (n == 2))).astype(np.uint8)


def check(cell, win, device) -> tuple[dict, int, list[str]]:
    limits = cell.config["correct_limits"]
    kept = sorted(win.sample.kept, key=lambda s: s[0])
    per_step = []
    for _, _, (before, after) in kept:
        ref = life_step(before.cpu().numpy())
        per_step.append(int((after.cpu().numpy() != ref).sum()))
    out = {"cells_off": (max(per_step, default=0), limits["cells_off"]),
           "steps_not_run": (win.unlaunched, limits["steps_not_run"])}
    failed = sum(v > limits["cells_off"] for v in per_step) + win.unlaunched
    lines = [f"sampled steps {[s[0] for s in kept]}, cells off the "
             f"reference {per_step}"]
    return out, failed, lines

"""The check of an exact all-pairs N-body configuration: each sampled step
run again from its state before by the plain reference
(perfbench/reference/nbody_brute.py) on the card, and the steps that ran
no work.

The same four numbers as perfbench/checks/nbody.py, each against the
configuration's ``correct_limits``, compared index for index: the
all-pairs step keeps the array order and has no runaway kill, so no
order is applied and no body is left out.

* ``pos_off_ulps``: the largest distance between the program's and the
  reference's position of a body after the step, in float32 spacings at
  the reference's position (the spacing of its larger coordinate). A
  reordered or wrong step reads in the millions.
* ``accel_rel_err``: the largest error of the program's acceleration
  against the float32 reference's, each being (v after - v before) / dt,
  the error over max(|a_ref|, median |a_ref|). Both sum the same exact
  terms, so only float32 rounding may part them.
* ``accel_p99_vs_exact``: the 99th percentile, over 4,096 bodies drawn
  from the step's index, of |a_program - a_exact| / |a_exact| against
  float64 all pairs: float32 rounding alone for an exact step; an
  approximation reads its own error.
* ``steps_not_run``: the frames in which the program launched no kernel
  B5, by the entry's ``launches`` hook.
"""

from __future__ import annotations

import torch

from perfbench.checks.nbody import FAULT, TARGETS, _finite, _spacing
from perfbench.reference import nbody, nbody_brute

NAMES = ("pos_off_ulps", "accel_rel_err", "accel_p99_vs_exact")


def compare(cfg: dict, before, after, index: int) -> dict[str, float]:
    """The three numbers of one step: `before` the program's state
    (px, py, vx, vy, m) before it, `after` its state after it, `index`
    the frame's index (it seeds the exact-force targets)."""
    rx, ry, rvx, rvy, _ = nbody_brute.step(*before, dt=cfg["dt"])
    px, py, vx, vy, _ = (a.double() for a in after)
    bvx, bvy = before[2].double(), before[3].double()

    dist = torch.hypot(px - rx.double(), py - ry.double())
    ulps = dist / _spacing(torch.maximum(rx.abs(), ry.abs()))

    dt = cfg["dt"]
    ax, ay = (vx - bvx) / dt, (vy - bvy) / dt
    rax, ray = (rvx.double() - bvx) / dt, (rvy.double() - bvy) / dt
    mag = torch.hypot(rax, ray)
    err = torch.hypot(ax - rax, ay - ray) / torch.clamp(
        mag, min=float(mag.median()))

    n = px.shape[0]
    g = torch.Generator().manual_seed(index)
    pick = torch.randperm(n, generator=g)[:TARGETS].to(px.device)
    ex, ey = nbody.exact_accel(before[0], before[1], before[4], pick)
    rel = torch.hypot(ax[pick] - ex, ay[pick] - ey) / torch.hypot(ex, ey)
    return {"pos_off_ulps": _finite(ulps.max()),
            "accel_rel_err": _finite(err.max()),
            "accel_p99_vs_exact": _finite(torch.quantile(
                torch.nan_to_num(rel, nan=FAULT), 0.99))}


def check(cell, win, device) -> tuple[dict, int, list[str]]:
    """-> ({name: (value, limit)}, frames that failed, lines for stderr)."""
    cfg = cell.config
    limits = cfg["correct_limits"]
    kept = sorted(win.sample.kept, key=lambda s: s[0])
    per_step = [compare(cfg, before, after, i)
                for i, _, (before, after) in kept]
    out = {k: (max((s[k] for s in per_step), default=0.0), limits[k])
           for k in NAMES}
    out["steps_not_run"] = (win.unlaunched, limits["steps_not_run"])
    failed = sum(any(s[k] > limits[k] for k in NAMES) for s in per_step)
    failed += win.unlaunched
    lines = [f"sampled steps {[s[0] for s in kept]}, "
             + "; ".join(f"{k} {[s[k] for s in per_step]}" for k in NAMES)]
    return out, failed, lines

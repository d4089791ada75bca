"""The plain reference of one exact all-pairs N-body step, in plain torch.

Written from the upstream experiment (blitzcode/rust-exp,
rs-src/nbody.rs:106-184, 197-200): at theta 0, nb_step_barnes_hut hands
the step to nb_step_brute_force, which sums the softened force law over
every pair and takes one explicit Euler step. It imports nothing of the
measured program. float32 unless asked for another dtype (the control's
bfloat16):

* force law (nbody.rs:164-184): softened gravity with an unnormalised
  direction, f(i <- j) = m_i m_j (p_j - p_i) / (|p_j - p_i|^2 + EPS),
  EPS = 1e-4, summed over every source j; a body's own term is exactly
  zero (its direction is);
* explicit Euler (nbody.rs:150-161): f = a m, v += dt f / m, p += dt v.
  No runaway kill: upstream applies it on the tree path only
  (nbody.rs:451-471).

Departures from nbody.rs:

1. The sum runs per unit target mass, a = sum_j m_j d / (|d|^2 + EPS),
   and the step multiplies by m_i after it, as the program does; upstream
   forms m_i m_j inside the sum. In float32 the two differ by rounding.
2. Upstream divides by |d|^2 + EPS; this reference divides too, where the
   program takes an IEEE reciprocal (``__frcp_rn``) and then multiplies.
   They differ by one rounding a term.
3. The sources are summed in fixed-order chunks, each chunk's sum added
   in turn, where upstream adds one pair at a time; the program sums in
   its own order. Only float32 rounding parts the three.
4. The bodies keep the array order; upstream keeps it too.
"""

from __future__ import annotations

import torch

from perfbench.reference.nbody import CHUNK_ELEMS, EPS

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def accel_all_pairs(px, py, m):
    """(ax, ay) [n] in the inputs' dtype: the all-pairs field per unit
    target mass, sources summed in chunks of at most CHUNK_ELEMS
    [n, sources] elements, in chunk order."""
    n = px.shape[0]
    chunk = max(1, CHUNK_ELEMS // max(n, 1))
    ax, ay = torch.zeros_like(px), torch.zeros_like(py)
    tx, ty = px[:, None], py[:, None]
    for s0 in range(0, n, chunk):
        s = slice(s0, s0 + chunk)
        dx, dy = px[s][None, :] - tx, py[s][None, :] - ty
        w = m[s][None, :] / (dx * dx + dy * dy + EPS)
        ax = ax + (w * dx).sum(dim=1)
        ay = ay + (w * dy).sum(dim=1)
    return ax, ay


def euler(px, py, vx, vy, m, ax, ay, dt: float):
    """(px, py, vx, vy) after one Euler step on the field (ax, ay) per
    unit mass: f = a m, v += dt f / m, p += dt v (nbody.rs:150-161)."""
    fx, fy = ax * m, ay * m
    vx = vx + dt * fx / m
    vy = vy + dt * fy / m
    return px + dt * vx, py + dt * vy, vx, vy


def step(px, py, vx, vy, m, dt: float, dtype: torch.dtype = torch.float32):
    """One step from the state (px, py, vx, vy, m) -> (px, py, vx, vy, m)
    after it, in the same order, as float32. `dtype` is the precision of
    every float op."""
    px, py, vx, vy, m = (a.to(dtype) for a in (px, py, vx, vy, m))
    ax, ay = accel_all_pairs(px, py, m)
    out = euler(px, py, vx, vy, m, ax, ay, dt)
    return tuple(a.float() for a in (*out, m))

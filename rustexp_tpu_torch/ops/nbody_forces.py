"""N-body forces as plain torch ops: the dense and blocked all-pairs forms,
the Euler step and the runaway kill.

Port of rustexp_tpu/ops/nbody_forces.py. Force law of the reference
(nbody.rs:164-184), softened gravity with an unnormalized direction,

    f_vec(i<-j) = m_i * m_j * (p_j - p_i) / (|p_j - p_i|^2 + EPS),

EPS = 1e-4 (nbody.rs:17), and explicit Euler v += dt*f/m; p += dt*v
(nbody.rs:150-161). The kernel form is ops/nbody_pallas.py (B5); the block
Barnes-Hut step is ops/nbody_bh.py.
"""

from __future__ import annotations

import torch

EPS = 1e-4  # softening, nbody.rs:17


def _pair_forces(px_t, py_t, m_t, px_s, py_s, m_s, self_mask=None):
    """Forces on targets [T] from sources [S]; returns (fx[T], fy[T])."""
    dx = px_s[None, :] - px_t[:, None]
    dy = py_s[None, :] - py_t[:, None]
    d2 = dx * dx + dy * dy + EPS
    f = (m_t[:, None] * m_s[None, :]) / d2
    if self_mask is not None:
        f = torch.where(self_mask, 0.0, f)
    return (f * dx).sum(dim=1), (f * dy).sum(dim=1)


def forces_dense(px, py, m):
    """All-pairs forces with i == j excluded; builds [N, N]."""
    n = px.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=px.device)
    return _pair_forces(px, py, m, px, py, m, self_mask=eye)


def forces_blocked(px, py, m, block: int = 1024):
    """All-pairs forces summed source block by source block, [N, block]
    at a time (the JAX form scans target blocks too; each target still
    sums its source blocks in order). i == j is excluded by global index.
    N must be a multiple of `block`."""
    n = px.shape[0]
    if n % block:
        raise ValueError(f"pad the particle count {n} to a multiple of "
                         f"block {block}")
    idx = torch.arange(n, device=px.device)
    fx = torch.zeros_like(px)
    fy = torch.zeros_like(py)
    for lo in range(0, n, block):
        hi = lo + block
        mask = idx[:, None] == idx[None, lo:hi]
        bx, by = _pair_forces(px, py, m, px[lo:hi], py[lo:hi], m[lo:hi],
                              self_mask=mask)
        fx = fx + bx
        fy = fy + by
    return fx, fy


def euler(px, py, vx, vy, m, fx, fy, dt: float):
    """v += dt*f/m; p += dt*v (nbody.rs:150-161)."""
    vx = vx + dt * fx / m
    vy = vy + dt * fy / m
    return px + dt * vx, py + dt * vy, vx, vy


def step_brute_force(px, py, vx, vy, m, block: int = 0, dt: float = 0.01):
    """One Euler step (nb_step_brute_force, nbody.rs:106-162)."""
    if block and px.shape[0] % block == 0 and px.shape[0] > block:
        fx, fy = forces_blocked(px, py, m, block)
    else:
        fx, fy = forces_dense(px, py, m)
    return euler(px, py, vx, vy, m, fx, fy, dt)


def kill_runaway(px, py, vx, vy, vp_wdh: float = 100.0,
                 vp_org=(0.0, 0.0)):
    """Zero velocity outside 0.55*viewport (reference hack,
    nbody.rs:460-471)."""
    out = ((vp_org[0] - px).abs() > vp_wdh * 0.55) | (
        (vp_org[1] - py).abs() > vp_wdh * 0.55)
    return torch.where(out, 0.0, vx), torch.where(out, 0.0, vy)

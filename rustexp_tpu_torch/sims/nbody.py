"""Gravitational N-body experiment.

Port of rustexp_tpu/sims/nbody.py (reference rs-src/nbody.rs, sim and
render, and hs-src/RustNBodyExperiment.hs, the driver: N = 10,000 stable
orbits, dt = 0.01, theta = 0.85). State is the f32 tensors (px, py, vx,
vy, m) on the experiment's device.

Routing (select_backend, as in JAX): theta == 0, N < BH_MIN_N or N with
no block size in BH_BLOCKS take brute force, through kernel B5
(ops/nbody_pallas.py) when N % 1024 == 0 and the dense torch form
otherwise; the rest take block Barnes-Hut (ops/nbody_bh.py), whose Morton
sort runs kernel B6 at power-of-two N. There is no Prewarmer: eager
PyTorch has no compile to hide, so a theta change applies at the next
step, and the routing it implies goes to core.trace's trace_info.

Initial conditions are drawn with core/prng.py, jax.random's threefry,
from the key JAX's init makes of the same seed, so a seed gives JAX's
particle set (positions and velocities within 2 ulps, see the initial
conditions below); the state carries the key on as JAX's does.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import prng, trace
from ..core.colors import trunc_i32
from ..core.timing import FrameTimes
from ..core.trace import trace_info
from ..ops import nbody_bh, nbody_forces, nbody_pallas
from ..ops.ieee import cos_sin, sqrt_rn
from ..runtime import device as pick_device, require_on

# Viewport over the simulation (nbody.rs:13-15)
VP_WDH = 100.0
VP_ORG_X = 0.0
VP_ORG_Y = 0.0


# ---------------------------------------------------------------------------
# Initial conditions (nbody.rs:39-104): JAX's draws, split for split
# (rustexp_tpu/sims/nbody.py:36-64). The uniforms and masses are JAX's bit
# for bit; cos and sin are within an ulp of XLA:CPU's, which are not
# correctly rounded, so positions and velocities are within 2 ulps of
# JAX's, and the same bits on the CPU and the card.
# ---------------------------------------------------------------------------

_TWO_PI = float(np.float32(2.0 * math.pi))  # JAX's weakly typed 2.0 * pi


def random_disk(key: torch.Tensor, n: int,
                device: torch.device | str | None = None):
    """Uniform disk of radius 23, velocity in +-3.5, mass in 0.1-1.5
    (nbody.rs:40-64) from a prng key, on `device` (the card by default)."""
    dev = pick_device(device)
    k1, k2, k3, k4 = prng.split(key, 4)
    u = prng.uniform(k1, (n,), device=dev)
    v = prng.uniform(k2, (n,), device=dev)
    r = sqrt_rn(u) * 23.0
    cos, sin = cos_sin(_TWO_PI * v)
    vel = prng.uniform(k3, (n, 2), -3.5, 3.5, device=dev)
    m = prng.uniform(k4, (n,), 0.1, 1.5, device=dev)
    return (r * cos, r * sin, vel[:, 0].contiguous(), vel[:, 1].contiguous(),
            m)


def stable_orbits(key: torch.Tensor, n: int, rmin: float = 0.5,
                  rmax: float = 30.0,
                  device: torch.device | str | None = None):
    """Sun (mass 1000) at the origin and n - 1 planets (mass 1) on circular
    orbits, v = sqrt(G*M) (nbody.rs:74-104), from a prng key, on `device`
    (the card by default)."""
    dev = pick_device(device)
    sun_mass, planet_mass, g = 1000.0, 1.0, 1.0
    speed = float(np.float32(math.sqrt(g * sun_mass)))
    k1, k2 = prng.split(key)
    r = (prng.uniform(k1, (n - 1,), device=dev)
         * float(np.float32(rmax - rmin)) + float(np.float32(rmin)))
    cos, sin = cos_sin(_TWO_PI * prng.uniform(k2, (n - 1,), device=dev))
    zero = torch.zeros(1, device=dev)
    px = torch.cat([zero, r * cos])
    py = torch.cat([zero, r * sin])
    vx = torch.cat([zero, -speed * sin])
    vy = torch.cat([zero, speed * cos])
    m = torch.cat([torch.full((1,), sun_mass, device=dev),
                   torch.full((n - 1,), planet_mass, device=dev)])
    return px, py, vx, vy, m


# ---------------------------------------------------------------------------
# Render (nb_draw, nbody.rs:482-583): saturating splats + velocity tail.
# ---------------------------------------------------------------------------

# Golden body/tail colours (nbody.rs:520-521): rgb(255,215,130) x 0.3 / 0.25
_BODY = (76, 64, 39)   # r, g, b after factor 0.3 and truncation
_TAIL = (63, 53, 32)   # after factor 0.25

# Octant direction table (nbody.rs:543-552): E NE N NW W SW S SE.
_DIRS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
_CROSS = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1))


def nbody_render(px, py, vx, vy, w: int, h: int) -> torch.Tensor:
    """uint32 [h, w] ABGR frame: saturating-add splats of each body and
    its tail pixel (opposite its velocity's octant), then the magenta
    centre cross."""
    dev = px.device
    aspect = h / w
    x1 = VP_ORG_X - VP_WDH / 2.0
    y1 = (VP_ORG_Y - VP_WDH / 2.0) * aspect
    x2 = VP_ORG_X + VP_WDH / 2.0
    y2 = (VP_ORG_Y + VP_WDH / 2.0) * aspect
    scalex = (1.0 / (x2 - x1)) * w
    scaley = (1.0 / (y2 - y1)) * h
    xi = trunc_i32((px - x1) * scalex)  # XLA's saturating f32 -> i32
    yi = trunc_i32((py - y1) * scaley)

    # tail offset from the velocity octant (nbody.rs:540-554); divide by a
    # tensor: on the card a division by a Python scalar is a multiply
    angle = torch.atan2(vy, vx)
    octant = trunc_i32(8.0 * angle / angle.new_full((), 2.0 * math.pi)
                       + 8.0) % 8
    dirs = torch.tensor(_DIRS, dtype=torch.int32, device=dev)[octant.long()]
    xt, yt = xi - dirs[:, 0], yi - dirs[:, 1]

    # saturating sequential adds of non-negative colours == sum then clip
    acc = torch.zeros((3, h * w), dtype=torch.int32, device=dev)
    for xs, ys, rgb in ((xi, yi, _BODY), (xt, yt, _TAIL)):
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        flat = torch.where(ok, ys * w + xs, 0).long()
        weights = ok.to(torch.int32)
        for ch, val in enumerate(rgb):
            acc[ch].index_add_(0, flat, weights * val)
    r, g, b = acc.clamp(max=255).reshape(3, h, w)
    fb = r | (g << 8) | (b << 16)
    cross = torch.tensor(_CROSS, dtype=torch.long, device=dev)
    fb[h // 2 + cross[:, 1], w // 2 + cross[:, 0]] = 0x00FF00FF
    return fb.view(torch.uint32)


# ---------------------------------------------------------------------------
# Experiment driver
# ---------------------------------------------------------------------------


@dataclass
class NBodyState:
    px: torch.Tensor
    py: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    m: torch.Tensor
    dt: float = 0.01
    theta: float = 0.85            # 0 -> brute force (reference semantics)
    steps: int = 0
    step_times: FrameTimes = field(default_factory=FrameTimes)
    key: torch.Tensor | None = None  # a prng key, as JAX's NBodyState.key

    @property
    def n(self) -> int:
        return int(self.px.shape[0])


class NBodyExperiment:
    name = "NBody"

    # Block-size preference for Barnes-Hut: the largest divisor of N from
    # this tuple with more than 4 blocks; N with none takes brute force.
    BH_BLOCKS = (256, 200, 128, 125, 100, 64, 50, 32, 25)
    BH_MIN_N = 2048  # below this brute force is faster than sort+aggregate

    def __init__(self, device: torch.device | str | None = None):
        self.device = pick_device(device)

    def init(self, mode: str = "orbits", n: int = 10_000, rmin: float = 0.5,
             rmax: float = 30.0, seed: int = 0, dt: float = 0.01,
             theta: float = 0.85) -> NBodyState:
        """Defaults per reference driver (RustNBodyExperiment.hs:42-48)."""
        key, sub = prng.split(prng.key(seed))
        if mode == "disk":
            arrays = random_disk(sub, n, self.device)
        else:
            arrays = stable_orbits(sub, n, rmin, rmax, self.device)
        return NBodyState(*arrays, dt=dt, theta=theta, key=key)

    def select_backend(self, n: int, theta: float) -> tuple:
        """Step routing -> ("brute" | "bh", block or None): theta == 0 is
        brute force (nbody.rs:197-200), so are N < BH_MIN_N and N with no
        usable block; the rest is block Barnes-Hut."""
        block = next((b for b in self.BH_BLOCKS
                      if n % b == 0 and n // b > 4), None)
        if theta == 0.0 or n < self.BH_MIN_N or block is None:
            return "brute", None
        return "bh", block

    def step(self, state: NBodyState) -> NBodyState:
        """One step, ending in a synchronize. The whole call is the span
        ``frame`` and the synchronize ``experiment.sync``; each route's
        stages are ``nbody.*`` spans (ops/nbody_bh.py, and the brute
        route's ``nbody.brute`` and ``nbody.integrate``)."""
        with trace.span("frame"):
            require_on(self.device, (state.px, state.py, state.vx, state.vy,
                                     state.m), "the particle set")
            t0 = time.perf_counter()
            backend, block = self.select_backend(state.n, state.theta)
            if backend == "brute":
                if state.n % nbody_pallas.T_TILE == 0:
                    px, py, vx, vy = nbody_pallas.step_brute_pallas(
                        state.px, state.py, state.vx, state.vy, state.m,
                        1024, False, state.dt)
                else:
                    px, py, vx, vy = nbody_forces.step_brute_force(
                        state.px, state.py, state.vx, state.vy, state.m, 0,
                        state.dt)
            else:
                k = nbody_bh.theta_to_k(state.theta, state.n // block)
                px, py, vx, vy, m = nbody_bh.step_bh(
                    state.px, state.py, state.vx, state.vy, state.m, block,
                    k, state.dt)
                state.m = m  # the BH step returns a permuted particle set
            if px.device.type == "cuda":
                with trace.span("experiment.sync"):
                    torch.cuda.synchronize(px.device)
            state.px, state.py, state.vx, state.vy = px, py, vx, vy
            state.steps += 1
            state.step_times.push(time.perf_counter() - t0)
        return state

    def render(self, state: NBodyState, w: int, h: int) -> torch.Tensor:
        return nbody_render(state.px, state.py, state.vx, state.vy, w, h)

    def status(self, state: NBodyState) -> str:
        _, med, _, _ = state.step_times.stats()
        sps = 1.0 / med if med > 0 else 0.0
        backend, _ = self.select_backend(state.n, state.theta)
        algo = "brute" if backend == "brute" else f"bh(th={state.theta:.2f})"
        return (f"{state.steps} Steps, SPS: {sps:.0f}, {med * 1000:.2f}ms, "
                f"{state.n} Bodies, dt {state.dt}, {algo}")

    def _trace_replan(self, state: NBodyState) -> None:
        """Announce the route and K a theta change gives, in JAX's words
        (rustexp_tpu/sims/nbody.py:310-320); nothing recompiles here."""
        backend, block = self.select_backend(state.n, state.theta)
        if backend == "brute":
            trace_info(f"theta={state.theta:.2f}: routing to brute force")
        else:
            k = nbody_bh.theta_to_k(state.theta, state.n // block)
            trace_info(f"theta={state.theta:.2f}: block-BH K={k} exact near "
                       f"blocks")

    def handle_key(self, state: NBodyState, key: str) -> NBodyState:
        """Keys per reference RustNBodyExperiment.hs:81-98: Q/W/E reset
        (shift-insensitive), x/X halve/double dt, a/A lower/raise theta by
        0.05 within [0, 0.95]. Every key advances the state's prng key
        first, as JAX's does (rustexp_tpu/sims/nbody.py:357); a reset
        starts from the init key of seed 0."""
        if state.key is not None:  # a state made from arrays has none
            state.key, _ = prng.split(state.key)
        if key in ("Q", "q"):
            st = self.init(mode="orbits", n=10_000)
        elif key in ("W", "w"):
            st = self.init(mode="disk", n=10_000)
        elif key in ("E", "e"):
            st = self.init(mode="orbits", n=5, rmin=5.0, rmax=30.0)
        elif key == "X":
            state.dt *= 2.0
            return state
        elif key == "x":
            state.dt /= 2.0
            return state
        elif key in ("A", "a"):
            state.theta = (min(0.95, state.theta + 0.05) if key == "A"
                           else max(0.0, state.theta - 0.05))
            self._trace_replan(state)
            return state
        else:
            return state
        st.dt, st.theta = state.dt, state.theta
        return st

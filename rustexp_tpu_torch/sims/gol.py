"""Game of Life experiment.

Port of rustexp_tpu/sims/gol.py (reference rs-src/gol.rs, sim and render,
and hs-src/RustGoLExperiment.hs, the driver). ``steps_per_frame``
generations run per step; ``backend`` picks the stencil:

  * "auto"   — kernel B4 (ops/gol_bits.py, SWAR) when rows % 32 == 0, else
               "mxu";
  * "bits", "bits_banded" — kernel B4. B4 tiles any 32-row-aligned grid,
               so the JAX package's banded route past its VMEM ceiling
               is B4 here too;
  * "pallas" — kernel B8 (ops/gol_stencil.py, the fused f32 stencil);
  * "mxu", "roll" — gol_stencil.multi_step's circulant or roll form.

All backends give the same grid bit for bit. Random fills ('R') are
drawn with core/prng.py, jax.random's threefry, from the key JAX's init
makes of the same seed, so they equal the JAX package's grid for grid.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..assets.gol_patterns import PATTERNS, pattern_to_array
from ..core import prng
from ..core.timing import FrameTimes
from ..ops import gol_bits, gol_stencil
from ..runtime import device as pick_device, require_on

GRID_WDH = gol_stencil.GRID_WDH


def randomize(key: torch.Tensor, n: int = GRID_WDH,
              device: torch.device | str | None = None) -> torch.Tensor:
    """Uniform random fill, uint8 [n, n] (reference gol_randomize,
    gol.rs:18-29), JAX's bernoulli(key, 0.5) drawn on `device` (the card
    by default)."""
    return prng.bernoulli(key, 0.5, (n, n), device).to(torch.uint8)


def set_pattern(pattern, n: int = GRID_WDH,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Center `pattern` (uint8 [h, w] numpy) on an empty uint8 [n, n] grid
    (reference gol_set_pattern, gol.rs:200-225) on `device` (the card by
    default); cells past the edge are dropped."""
    dev = pick_device(device)
    h, w = pattern.shape
    grid = torch.zeros((n, n), dtype=torch.uint8)
    ys, xs = torch.from_numpy(pattern).nonzero(as_tuple=True)
    gy, gx = ys + (n // 2 - h // 2), xs + (n // 2 - w // 2)
    keep = (gy >= 0) & (gy < n) & (gx >= 0) & (gx < n)
    grid[gy[keep], gx[keep]] = 1
    return grid.to(dev)


def gol_render(grid: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """The grid centered into a uint32 [h, w] ABGR frame (reference
    gol_draw, gol.rs:172-198): background bytes 64 (0x40404040), alive
    0x00FFFFFF, dead 0. A frame smaller than the grid clips the blit."""
    n = grid.shape[0]
    i32 = dict(dtype=torch.int32, device=grid.device)
    fb = torch.full((h, w), 0x40404040, **i32)
    cell = torch.where(grid == 1, 0x00FFFFFF, 0).to(torch.int32)
    xoffs, yoffs = w // 2 - n // 2, h // 2 - n // 2
    if w >= n and h >= n:
        fb[yoffs:yoffs + n, xoffs:xoffs + n] = cell
        return fb.view(torch.uint32)
    ys = torch.arange(h, **i32)[:, None] - yoffs
    xs = torch.arange(w, **i32)[None, :] - xoffs
    inside = (ys >= 0) & (ys < n) & (xs >= 0) & (xs < n)
    vals = cell[ys.clamp(0, n - 1).long(), xs.clamp(0, n - 1).long()]
    return torch.where(inside, vals, fb).view(torch.uint32)


@dataclass
class GoLState:
    grid: torch.Tensor
    generations: int = 0
    steps_per_frame: int = 1
    backend: str = "auto"
    step_times: FrameTimes = field(default_factory=FrameTimes)
    key: torch.Tensor | None = None  # a prng key, as JAX's GoLState.key


class GoLExperiment:
    # The viewer runs the sim in a free-running worker thread
    # (app/viewer.py SimWorker). Safe because every route rebinds
    # state.grid to a new tensor (or, at k = 0, keeps the old one) and
    # none writes into a grid a reader may hold.
    decoupled = True
    name = "GoL"

    def __init__(self, device: torch.device | str | None = None):
        self.device = pick_device(device)

    def init(self, pattern: str = "ark", seed: int = 0,
             steps_per_frame: int = 1, n: int = GRID_WDH,
             backend: str = "auto") -> GoLState:
        """Initial pattern 'ark' matches the reference
        (RustGoLExperiment.hs:54)."""
        grid = set_pattern(pattern_to_array(PATTERNS[pattern]), n,
                           self.device)
        return GoLState(grid=grid, steps_per_frame=steps_per_frame,
                        backend=backend, key=prng.key(seed))

    @staticmethod
    def route(rows: int, backend: str) -> str:
        """The backend a step runs: "auto" is B4 ("bits") on a 32-row-
        aligned grid, else "mxu"; "bits_banded" is B4."""
        if backend == "auto":
            return "mxu" if rows % gol_bits.BITS else "bits"
        return "bits" if backend == "bits_banded" else backend

    def step(self, state: GoLState) -> GoLState:
        require_on(self.device, (state.grid,), "the GoL grid")
        t0 = time.perf_counter()
        k = state.steps_per_frame
        backend = self.route(state.grid.shape[0], state.backend)
        if backend == "bits":
            state.grid = gol_bits.multi_step_swar(state.grid, k)
        elif backend == "pallas":
            state.grid = gol_stencil.multi_step_pallas(state.grid, k)
        else:
            state.grid = gol_stencil.multi_step(state.grid, k, backend)
        if state.grid.device.type == "cuda":
            torch.cuda.synchronize(state.grid.device)
        state.step_times.push((time.perf_counter() - t0) / max(k, 1))
        state.generations += k
        return state

    def render(self, state: GoLState, w: int, h: int) -> torch.Tensor:
        return gol_render(state.grid, w, h)

    def status(self, state: GoLState) -> str:
        _, med, _, _ = state.step_times.stats()
        gps = 1.0 / med if med > 0 else 0.0
        n = state.grid.shape[0]
        return (
            f"{n}x{n} Grid, {state.generations} Gens, "
            f"{med * 1000:.2f}ms, GPS: {gps:.0f}, x{state.steps_per_frame} | "
            f"[R]nd [G]un [A]corn [F]ill ar[K] [T/Y]steps"
        )

    def handle_key(self, state: GoLState, key: str) -> GoLState:
        """Keys per reference RustGoLExperiment.hs:78-91; T doubles and Y
        halves steps_per_frame (rustexp_tpu/sims/gol.py:151-175)."""
        key = key.upper() if len(key) == 1 else key
        n = int(state.grid.shape[0])
        if key == "R":
            state.key, sub = prng.split(state.key)
            state.grid = randomize(sub, n, self.device)
            state.generations = 0
        elif key in ("G", "A", "F", "K"):
            name = {"G": "gun", "A": "acorn", "F": "spacefill",
                    "K": "ark"}[key]
            state.grid = set_pattern(pattern_to_array(PATTERNS[name]), n,
                                     self.device)
            state.generations = 0
        elif key == "T":
            state.steps_per_frame = min(64, state.steps_per_frame * 2)
        elif key == "Y":
            state.steps_per_frame = max(1, state.steps_per_frame // 2)
        return state

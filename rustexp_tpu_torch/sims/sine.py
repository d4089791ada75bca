"""Sine scroller: the 'hello world' experiment.

Port of rustexp_tpu/sims/sine.py (reference rs-src/sine_scroller.rs:4-17,
hs-src/RustSineExperiment.hs). The field is separable: one sine per
column and one per row, then their outer product.

The w + h sines are taken in float64 and rounded once to float32, on the
CPU and on the card alike, as ops.ieee.sqrt_rn takes its root: CUDA's
``sinf`` and the CPU's vectorized float32 sine are different
approximations, and one ulp can move ``trunc(... * 255)`` to the next
gray. The rounded sine is the true one, so the card's frame equals the
CPU's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.timing import FrameTimes
from ..runtime import device as pick_device

_TWO_PI = 2.0 * math.pi


def _gray_axis(n: int, tick: float, device: torch.device) -> torch.Tensor:
    """(sin((i / 64 + tick) * 2 pi) + 1) * 0.5 for i < n, f32 [n]: every
    op rounded to f32 as JAX's sine_frame writes it, the sine through
    float64."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    s = ((i / 64.0 + tick) * _TWO_PI).double().sin().float()
    return (s + 1.0) * 0.5


def sine_frame(w: int, h: int, tick, device: torch.device) -> torch.Tensor:
    """uint32 [h, w] grayscale frame (rustexp_tpu/sims/sine.py:22):
    gray = trunc(gy * gx * 255), pixel = gray | gray << 8 | gray << 16.
    `tick` is rounded to float32 first, as JAX does."""
    t = float(np.float32(tick))
    gx, gy = _gray_axis(w, t, device), _gray_axis(h, t, device)
    gray = (gy[:, None] * gx[None, :] * 255.0).to(torch.int32)
    return (gray | (gray << 8) | (gray << 16)).view(torch.uint32)


@dataclass
class SineState:
    tick: float = 0.0
    frame_times: FrameTimes = field(default_factory=FrameTimes)


class SineExperiment:
    name = "Rust Sine Scroller"  # display-name parity with the reference list

    def __init__(self, device: torch.device | str | None = None):
        self.device = pick_device(device)

    def init(self, **config) -> SineState:
        return SineState()

    def step(self, state: SineState, dt: float = 1.0 / 60.0) -> SineState:
        state.tick += dt
        return state

    def render(self, state: SineState, w: int, h: int) -> torch.Tensor:
        return sine_frame(w, h, state.tick, self.device)

    def status(self, state: SineState) -> str:
        _, med, _, _ = state.frame_times.stats()
        return f"{med * 1000.0:.2f}ms"

    def handle_key(self, state: SineState, key: str) -> SineState:
        return state

"""A simulation as the harness drives one: each frame is one step of
Conway's Life on a torus, in plain torch, from a grid drawn from the
run's seed. Its output is the step's state before and after."""

from __future__ import annotations

import torch

from perfbench.entries.common import NoRerenders


class Entry(NoRerenders):
    def __init__(self, cfg: dict, traffic: dict, device, seed: int = 0):
        g = torch.Generator(device=device).manual_seed(seed)
        shape = (cfg["height"], cfg["width"])
        self.state = (torch.rand(shape, generator=g, device=device)
                      < cfg["density"]).to(torch.uint8)
        self.steps = 0

    def launches(self) -> int:
        """Steps run so far: the work a frame has to do."""
        return self.steps

    def frame(self, tick: float):
        before = self.state
        n = sum(torch.roll(before, (dy, dx), (0, 1))
                for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx)
        self.state = ((n == 3) | ((before == 1) & (n == 2))).to(torch.uint8)
        self.steps += 1
        return (before, self.state), None

"""The Experiment protocol: the user-visible API of the engine.

Port of rustexp_tpu/sims/base.py (reference hs-src/Experiment.hs:22-36):

    init(config)            -> state            (withExperiment setup)
    step(state, ...)        -> state            (sim advance)
    render(state, w, h)     -> uint32[h, w]     (experimentDraw's fb fill)
    status(state)           -> str              (experimentStatusString)
    handle_key(state, key)  -> state            (experimentGLFWEvent)

The state is an explicit dataclass of tensors on the experiment's device
(``device``: the card unless the caller asks for the CPU); ``step``
rebinds its tensor fields to new tensors and never writes into one a
reader may hold (app/viewer.py SimWorker reads shallow copies).
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from ..runtime import device as pick_device


@runtime_checkable
class Experiment(Protocol):
    name: str
    device: torch.device

    def init(self, **config) -> Any: ...

    def step(self, state: Any) -> Any: ...

    def render(self, state: Any, w: int, h: int) -> Any: ...

    def status(self, state: Any) -> str: ...

    def handle_key(self, state: Any, key: str) -> Any: ...


class EmptyExperiment:
    """Reference Experiment.hs EmptyExperiment dummy."""

    name = "Empty"

    def __init__(self, device: torch.device | str | None = None):
        self.device = pick_device(device)

    def init(self, **config):
        return None

    def step(self, state):
        return state

    def render(self, state, w: int, h: int) -> torch.Tensor:
        return torch.zeros((h, w), dtype=torch.int32,
                           device=self.device).view(torch.uint32)

    def status(self, state):
        return ""

    def handle_key(self, state, key):
        return state

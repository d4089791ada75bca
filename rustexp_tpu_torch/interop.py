"""Carry the JAX package's state into the port.

The JAX package's Scene, Queue and BinnedTris are NamedTuple pytrees. A
caller turns one into ``{field: np.asarray(leaf)}`` (this module imports
no jax) and gets the port's tuple of tensors on `device`, so one scene,
queue or set of bins can drive both packages in the parity tests.
`device` defaults to the card (runtime.device); pass "cpu" for the CPU.
uint32 leaves (the cubemap cross) keep their bits as int32;
Queue.shade_w comes back a Python int, and Queue.order is "unknown"
unless the dict names it (a JAX queue does not record its order).

A GoL grid and an N-body particle set (px, py, vx, vy, m, as JAX's
stable_orbits or random_disk make them) come across as numpy arrays, to
the port's tensors or to a GoLState / NBodyState on `device`, with JAX's
uint32[2] PRNG key as the state's prng key (core/prng.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import prng
from .ops.raster_bins import BinnedTris
from .ops.raster_queue import Queue
from .raster.pipeline import Scene
from .runtime import device as pick_device
from .sims.gol import GoLState
from .sims.nbody import NBodyState


Device = torch.device | str | None


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def scene_from_numpy(d: dict, device: Device = None) -> Scene:
    dev = pick_device(device)
    return Scene(**{f: _tensor(d[f], dev) for f in Scene._fields})


def queue_from_numpy(d: dict, device: Device = None) -> Queue:
    dev = pick_device(device)
    fields = {f: _tensor(d[f], dev) for f in Queue._fields
              if f not in ("shade_w", "order")}
    return Queue(**fields, shade_w=int(d["shade_w"]),
                 order=str(d.get("order", "unknown")))


def bins_from_numpy(d: dict, device: Device = None) -> BinnedTris:
    dev = pick_device(device)
    return BinnedTris(**{f: _tensor(d[f], dev) for f in BinnedTris._fields})


def _with_key(state: dict) -> dict:
    if state.get("key") is not None:
        state["key"] = prng.as_key(state["key"])
    return state


def gol_state_from_numpy(grid, device: Device = None, **state) -> GoLState:
    """A GoLState around a {0, 1} cell grid of any integer dtype (kept);
    `state` sets the other fields (steps_per_frame, backend, key, ...)."""
    return GoLState(grid=_tensor(grid, pick_device(device)),
                    **_with_key(state))


def nbody_state_from_numpy(arrays, device: Device = None,
                           **state) -> NBodyState:
    """An NBodyState around (px, py, vx, vy, m) as f32 tensors; `state`
    sets the other fields (dt, theta, key, ...)."""
    dev = pick_device(device)
    return NBodyState(*(_tensor(np.asarray(a, np.float32), dev)
                        for a in arrays), **_with_key(state))

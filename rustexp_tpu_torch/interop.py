"""Carry a JAX-built Scene, Queue or BinnedTris into the port.

The JAX package's Scene, Queue and BinnedTris are NamedTuple pytrees. A
caller turns one into ``{field: np.asarray(leaf)}`` (this module imports
no jax) and gets the port's tuple of tensors on `device`, so one scene,
queue or set of bins can drive both packages in the parity tests.
uint32 leaves (the cubemap cross) keep their bits as int32;
Queue.shade_w comes back a Python int.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.raster_bins import BinnedTris
from .ops.raster_queue import Queue
from .raster.pipeline import Scene


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def scene_from_numpy(d: dict, device: torch.device | str = "cpu") -> Scene:
    return Scene(**{f: _tensor(d[f], device) for f in Scene._fields})


def queue_from_numpy(d: dict, device: torch.device | str = "cpu") -> Queue:
    fields = {f: _tensor(d[f], device) for f in Queue._fields
              if f != "shade_w"}
    return Queue(**fields, shade_w=int(d["shade_w"]))


def bins_from_numpy(d: dict, device: torch.device | str = "cpu") -> BinnedTris:
    return BinnedTris(**{f: _tensor(d[f], device) for f in BinnedTris._fields})

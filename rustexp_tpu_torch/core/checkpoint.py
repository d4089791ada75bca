"""Experiment state checkpoint and resume.

Port of rustexp_tpu/core/checkpoint.py. Every experiment state (a
dataclass of tensors and config scalars) round-trips through one
compressed npz:

  * tensor fields (grid, particle arrays) -> npz arrays, read back to
    the host once;
  * the prng key (core/prng.py) -> the uint32[2] array the JAX package
    saves for its jax.random key, so a resumed 'R' key draws what the
    uninterrupted run draws;
  * config scalars (dt, theta, steps_per_frame, ...) -> a JSON meta blob;
  * transient fields (timing rings, the rasterizer's scene cache) are
    dropped and rebuilt on resume.

The layout is the JAX package's, so either package loads the other's GoL
and N-body files. A file of the port's that holds a torch generator's
state (``gen``) loads its grid and scalars and keeps the init key.
GoL resumes bit-exactly; N-body resumes exactly from the saved float32
arrays. CLI: --save-state / --load-state.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from . import prng
from .trace import trace_info

# Rebuilt on resume, not persisted: timing rings and device-side caches.
_TRANSIENT = {"step_times", "frame_times", "_scene_cache"}


def save_state(path: str, state) -> str:
    """Write an experiment state dataclass to `path`; returns the path
    written. An extensionless path gains ".npz" here, as np.savez would
    add it, so the returned path is the one load_state opens."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    arrays, scalars = {}, {}
    for f in dataclasses.fields(state):
        if f.name in _TRANSIENT:
            continue
        v = getattr(state, f.name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            arrays[f.name] = v.detach().cpu().numpy()
        elif isinstance(v, (bool, int, float, str)):
            scalars[f.name] = v
    meta = json.dumps({"type": type(state).__name__, "scalars": scalars})
    arrays["__meta__"] = np.frombuffer(meta.encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_state(path: str, experiment):
    """Rebuild a state for `experiment` from a save_state() file, its
    tensors on the experiment's device.

    Starts from experiment.init() (fresh transients, defaults for fields
    added since the save), then overlays the saved scalars, tensors and
    prng key.
    """
    path = str(path)
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"  # the extensionless alias save_state took
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]))
        state = experiment.init()
        want = type(state).__name__
        if meta["type"] != want:
            raise ValueError(
                f"checkpoint {path} holds a {meta['type']}, expected {want}")
        for k, v in meta["scalars"].items():
            setattr(state, k, v)
        for k in data.files:
            if k == "__meta__":
                continue
            if k in meta.get("generators", ()):
                trace_info(f"checkpoint {path}: {k!r} is a torch generator's "
                           "state, which no longer seeds the port; the "
                           "state keeps the init key")
            elif k == "key":
                state.key = prng.as_key(data[k])
            else:
                setattr(state, k,
                        torch.from_numpy(data[k]).to(experiment.device))
    return state

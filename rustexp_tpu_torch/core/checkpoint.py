"""Experiment state checkpoint and resume.

Port of rustexp_tpu/core/checkpoint.py. Every experiment state (a
dataclass of tensors and config scalars) round-trips through one
compressed npz:

  * tensor fields (grid, particle arrays) -> npz arrays, read back to
    the host once;
  * torch.Generator fields (GoL's ``gen``, the counterpart of the JAX
    package's PRNG key) -> their ``get_state()`` bytes, restored with
    ``set_state``, so a resumed 'R' key draws what the uninterrupted run
    draws;
  * config scalars (dt, theta, steps_per_frame, ...) -> a JSON meta blob;
  * transient fields (timing rings, the rasterizer's scene cache) are
    dropped and rebuilt on resume.

GoL resumes bit-exactly; N-body resumes exactly from the saved float32
arrays. CLI: --save-state / --load-state.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

# Rebuilt on resume, not persisted: timing rings and device-side caches.
_TRANSIENT = {"step_times", "frame_times", "_scene_cache"}


def save_state(path: str, state) -> str:
    """Write an experiment state dataclass to `path`; returns the path
    written. An extensionless path gains ".npz" here, as np.savez would
    add it, so the returned path is the one load_state opens."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    arrays, scalars, generators = {}, {}, []
    for f in dataclasses.fields(state):
        if f.name in _TRANSIENT:
            continue
        v = getattr(state, f.name)
        if v is None:
            continue
        if isinstance(v, torch.Generator):
            arrays[f.name] = v.get_state().numpy()
            generators.append(f.name)
        elif isinstance(v, torch.Tensor):
            arrays[f.name] = v.detach().cpu().numpy()
        elif isinstance(v, (bool, int, float, str)):
            scalars[f.name] = v
    meta = json.dumps({"type": type(state).__name__, "scalars": scalars,
                       "generators": generators})
    arrays["__meta__"] = np.frombuffer(meta.encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_state(path: str, experiment):
    """Rebuild a state for `experiment` from a save_state() file, its
    tensors on the experiment's device.

    Starts from experiment.init() (fresh transients, defaults for fields
    added since the save), then overlays the saved scalars, tensors and
    generator states.
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
            t = torch.from_numpy(data[k])
            if k in meta["generators"]:
                gen = torch.Generator()
                gen.set_state(t)
                setattr(state, k, gen)
            else:
                setattr(state, k, t.to(experiment.device))
    return state

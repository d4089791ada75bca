"""Irradiance cubemap sets: loading, orientation, preview cross, registry.

A set is five cubemaps pre-convolved with cos^{0,1,8,64,512} lobes
(reflection, diffuse, and three specular powers — reference
rasterizer.rs:492-527), each six 64x64 HDR faces named
``env_cos_{power}_{x+|x-|y+|y-|z+|z-}.hdr`` (rasterizer.rs:570-583).

TPU-first layout: one dense float32 array ``[5, 6, 64, 64, 3]`` per set so
every shader lookup is a single gather into one device-resident table; the
whole 9-set library stacks to ``[9, 5, 6, 64, 64, 3]`` (~33 MB) and can stay
in HBM.

Port of rustexp_tpu/assets/cubemap.py: the same numpy code, on the port's
own colors, HDR loader and asset paths. The sets stay numpy;
pipeline.make_scene moves them to the device.

Faces are flipped/mirrored at load into "lookup orientation" exactly as the
reference does (rasterizer.rs:607-622), so a texel lookup is
``face[ty, tx]`` with u -> tx, v -> ty.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..core.colors import pack_abgr32_gamma_np
from . import paths
from .hdr import load_hdr

CM_FACE_WDH = 64
POWERS = (0, 1, 8, 64, 512)
FACE_NAMES = ("x+", "x-", "y+", "y-", "z+", "z-")
X_POS, X_NEG, Y_POS, Y_NEG, Z_POS, Z_NEG = range(6)

# (flip_x, flip_y) per face, reference rasterizer.rs:610-622: the assets are
# in OpenGL orientation; flip into the convenient lookup orientation.
_FACE_FLIPS = (
    (True, True),    # x+
    (False, True),   # x-
    (False, False),  # y+
    (False, True),   # y-
    (False, True),   # z+
    (True, True),    # z-
)


@dataclass
class CubeMapSet:
    name: str
    data: np.ndarray   # f32 [5, 6, 64, 64, 3] indexed [power, face, ty, tx]
    cross: np.ndarray  # u32 [cross_hgt, cross_wdh] ABGR preview (alpha 255 on cross)

    @property
    def cross_hgt(self) -> int:
        return self.cross.shape[0]

    @property
    def cross_wdh(self) -> int:
        return self.cross.shape[1]


def _load_face(path: str, flip_x: bool, flip_y: bool) -> np.ndarray:
    img = load_hdr(path)
    if img.shape[0] != CM_FACE_WDH or img.shape[1] != CM_FACE_WDH:
        raise ValueError(f"{path}: wrong cubemap face dimensions {img.shape}")
    if flip_x:
        img = img[:, ::-1]
    if flip_y:
        img = img[::-1, :]
    return np.ascontiguousarray(img, dtype=np.float32)


def load_cm(power: int, path: str) -> np.ndarray:
    """All six faces of one convolution power -> f32 [6, 64, 64, 3]."""
    faces = []
    for fi, fname in enumerate(FACE_NAMES):
        fx, fy = _FACE_FLIPS[fi]
        faces.append(_load_face(
            os.path.join(path, f"env_cos_{power}_{fname}.hdr"), fx, fy))
    return np.stack(faces)


def cm_texel_to_dir(face: int, x, y) -> np.ndarray:
    """Texel center on a face -> unit direction (rasterizer.rs:726-740)."""
    vw = (np.asarray(x, dtype=np.float32) + 0.5) / CM_FACE_WDH * 2.0 - 1.0
    vh = (np.asarray(y, dtype=np.float32) + 0.5) / CM_FACE_WDH * 2.0 - 1.0
    one = np.ones_like(vw)
    if face == X_POS:
        d = np.stack([one, vh, vw], -1)
    elif face == X_NEG:
        d = np.stack([-one, vh, vw], -1)
    elif face == Y_POS:
        d = np.stack([vw, one, vh], -1)
    elif face == Y_NEG:
        d = np.stack([vw, -one, vh], -1)
    elif face == Z_POS:
        d = np.stack([vw, vh, one], -1)
    else:
        d = np.stack([vw, vh, -one], -1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def draw_cm_cross_buffer(cm: np.ndarray) -> np.ndarray:
    """Unfolded half-size LDR cross preview of a [6,64,64,3] cubemap.

    Layout (reference rasterizer.rs:624-678), alpha=255 marks cross pixels::

           Y+
        X- Z- X+ Z+
           Y-
    """
    half = CM_FACE_WDH // 2
    cross = np.zeros((3 * half, 4 * half), dtype=np.uint32)
    # (xoff, yoff, flip_x, flip_y) per face for display orientation
    placement = {
        X_POS: (2, 1, False, False),
        X_NEG: (0, 1, True, False),
        Y_POS: (1, 2, False, False),
        Y_NEG: (1, 0, False, True),
        Z_POS: (3, 1, True, False),
        Z_NEG: (1, 1, False, False),
    }
    for face, (xoff, yoff, flip_x, flip_y) in placement.items():
        xs = np.arange(half) * 2
        ys = np.arange(half) * 2
        if flip_x:
            xs = (half - 1 - np.arange(half)) * 2
        if flip_y:
            ys = (half - 1 - np.arange(half)) * 2
        block = cm[face][ys[:, None], xs[None, :]]  # [half, half, 3]
        packed = pack_abgr32_gamma_np(block) | np.uint32(0xFF000000)
        cross[yoff * half : (yoff + 1) * half, xoff * half : (xoff + 1) * half] = packed
    return cross


def load_cm_set(path: str, name: str = "") -> CubeMapSet:
    data = np.stack([load_cm(p, path) for p in POWERS])
    return CubeMapSet(name or os.path.basename(path), data,
                      draw_cm_cross_buffer(data[0]))


# ---------------------------------------------------------------------------
# Procedural fallback: analytic sky so the engine runs without asset files.
# ---------------------------------------------------------------------------


def make_procedural_set(name: str = "ProceduralSky") -> CubeMapSet:
    """Analytic horizon-gradient + sun-lobe environment, cos^p convolutions
    approximated by blending toward the hemispherical mean with power."""
    sun = np.array([0.577, 0.577, 0.577], dtype=np.float32)
    grids = []
    for face in range(6):
        xs, ys = np.meshgrid(np.arange(CM_FACE_WDH), np.arange(CM_FACE_WDH),
                             indexing="xy")
        d = cm_texel_to_dir(face, xs, ys)  # [64, 64, 3] (x varies along axis 1)
        grids.append(d)
    dirs = np.stack(grids)  # [6, 64, 64, 3]

    def radiance(d, p):
        horizon = np.array([0.35, 0.45, 0.6], dtype=np.float32)
        zenith = np.array([0.1, 0.2, 0.5], dtype=np.float32)
        ground = np.array([0.25, 0.2, 0.15], dtype=np.float32)
        t = np.clip(d[..., 1], -1.0, 1.0)
        sky = np.where(t[..., None] >= 0,
                       horizon + (zenith - horizon) * t[..., None],
                       horizon + (ground - horizon) * (-t[..., None]))
        sd = np.clip((d * sun).sum(-1), 0.0, 1.0)
        blur = 1.0 / (1.0 + 0.1 * p)
        sunlobe = (sd ** max(1.0, p / 4.0 + 1.0))[..., None] * 4.0 * blur
        mean = np.array([0.3, 0.33, 0.4], dtype=np.float32)
        w = 1.0 / (1.0 + p)  # higher power -> sharper -> less mean blending
        return (sky * (1 - w) + mean * w + sunlobe).astype(np.float32)

    data = np.stack([radiance(dirs, p) for p in POWERS])
    return CubeMapSet(name, data, draw_cm_cross_buffer(data[0]))


# ---------------------------------------------------------------------------
# Registry: the reference's 9 sets (rasterizer.rs:774-806).
# ---------------------------------------------------------------------------

CM_TABLE = (
    ("Grace", "grace"),
    ("ParkingLot", "parking_lot"),
    ("Enis", "enis"),
    ("Glacier", "glacier"),
    ("Pisa", "pisa"),
    ("PineTree", "pine_tree"),
    ("Uffizi", "uffizi"),
    ("Doge", "doge"),
    ("ColTest", "coltest"),
)

NUM_CM_SETS = len(CM_TABLE)

_cache: dict[int, CubeMapSet] = {}


def cm_set_name(idx: int) -> str:
    return CM_TABLE[idx][0]


def get_cm_set(idx: int) -> CubeMapSet:
    if idx in _cache:
        return _cache[idx]
    name, dirname = CM_TABLE[idx]
    edir = paths.envmap_dir()
    cs = None
    if edir is not None:
        p = os.path.join(edir, dirname)
        if os.path.isdir(p):
            cs = load_cm_set(p, name=name)
    if cs is None:
        cs = make_procedural_set(name + " (procedural)")
    _cache[idx] = cs
    return cs

"""The benchmark's own inputs: meshes, the cube-map set and camera paths.

Frozen copies of the procedural stand-ins that the measured program falls
back to when the reference's asset files are absent (a UV sphere for
Killeroo, the 12-triangle cube for Cube, an analytic sky for envmap 0),
and of the reference's camera paths (blitzcode/rust-exp rasterizer.rs:
417-473). Plain numpy; nothing here imports the program. Set-up holds the
program's loaded arrays to these, so both sides render the same inputs.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np

CM_W = 64
POWERS = (0, 1, 8, 64, 512)


@dataclass
class Mesh:
    positions: np.ndarray  # f32 [V, 3]
    normals: np.ndarray    # f32 [V, 3]
    colors: np.ndarray     # f32 [V, 3]
    tris: np.ndarray       # i32 [T, 3]


def sphere(n_lat: int = 24, n_lon: int = 48) -> Mesh:
    """UV sphere, 2 * n_lat * n_lon triangles, normals = positions."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    xyz = np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            tris += [[a, c, b], [b, c, d]]
    return Mesh(xyz, xyz.copy(), np.ones_like(xyz),
                np.asarray(tris, dtype=np.int32))


def cube() -> Mesh:
    """Unit cube, 12 triangles, per-face normals, white."""
    faces = []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            n = np.zeros(3, dtype=np.float32)
            n[axis] = sgn
            u = np.zeros(3, dtype=np.float32)
            v = np.zeros(3, dtype=np.float32)
            u[(axis + 1) % 3] = 1.0
            v[(axis + 2) % 3] = 1.0
            if sgn < 0:
                u, v = v, u
            c = n * 0.5
            faces.append((c - 0.5 * u - 0.5 * v, c + 0.5 * u - 0.5 * v,
                          c + 0.5 * u + 0.5 * v, c - 0.5 * u + 0.5 * v, n))
    pos, nrm, tris = [], [], []
    for i, (a, b, c_, d, n) in enumerate(faces):
        base = 4 * i
        pos += [a, b, c_, d]
        nrm += [n] * 4
        tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    pos = np.asarray(pos, dtype=np.float32)
    return Mesh(pos, np.asarray(nrm, dtype=np.float32), np.ones_like(pos),
                np.asarray(tris, dtype=np.int32))


MESHES = {"sphere": sphere, "cube": cube}


def gamma_lut() -> np.ndarray:
    """uint8 [2048]: round((i / 2047)^(1/2.2) * 255) (rasterizer.rs:1389)."""
    i = np.arange(2048, dtype=np.float32)
    v = np.power(i / np.float32(2047.0), np.float32(1.0 / 2.2),
                 dtype=np.float32)
    return np.round(v * np.float32(255.0)).astype(np.uint8)


def _pack_gamma_np(rgb: np.ndarray) -> np.ndarray:
    """rgb f32 [..., 3] -> uint32 ABGR through the 11-bit gamma table."""
    lut = gamma_lut()
    i = (rgb.astype(np.float32) * np.float32(2047.0)).astype(np.int32)
    ri, gi, bi = i[..., 0], i[..., 1], i[..., 2]

    def chan(idx, neg):
        v = lut[np.clip(idx, 0, 2047)].astype(np.uint32)
        return np.where(neg, np.uint32(0),
                        np.where(idx > 2047, np.uint32(255), v))

    return (chan(ri, ri < 0) | (chan(gi, gi < 0) << 8)
            | (chan(bi, ri < 0) << 16)).astype(np.uint32)


def _texel_dirs(face: int, x, y) -> np.ndarray:
    """Texel centre on a face -> unit direction (rasterizer.rs:726-740)."""
    vw = (np.asarray(x, dtype=np.float32) + 0.5) / CM_W * 2.0 - 1.0
    vh = (np.asarray(y, dtype=np.float32) + 0.5) / CM_W * 2.0 - 1.0
    one = np.ones_like(vw)
    d = {0: (one, vh, vw), 1: (-one, vh, vw), 2: (vw, one, vh),
         3: (vw, -one, vh), 4: (vw, vh, one), 5: (vw, vh, -one)}[face]
    d = np.stack(d, -1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def cross_preview(cm0: np.ndarray) -> np.ndarray:
    """The unfolded half-size cross of the cos^0 map, uint32 ABGR with
    alpha 255 on the cross (rasterizer.rs:624-678)."""
    half = CM_W // 2
    cross = np.zeros((3 * half, 4 * half), dtype=np.uint32)
    placement = {0: (2, 1, False, False), 1: (0, 1, True, False),
                 2: (1, 2, False, False), 3: (1, 0, False, True),
                 4: (3, 1, True, False), 5: (1, 1, False, False)}
    for face, (xoff, yoff, flip_x, flip_y) in placement.items():
        xs = np.arange(half) * 2
        ys = np.arange(half) * 2
        if flip_x:
            xs = (half - 1 - np.arange(half)) * 2
        if flip_y:
            ys = (half - 1 - np.arange(half)) * 2
        block = cm0[face][ys[:, None], xs[None, :]]
        packed = _pack_gamma_np(block) | np.uint32(0xFF000000)
        cross[yoff * half:(yoff + 1) * half,
              xoff * half:(xoff + 1) * half] = packed
    return cross


def procedural_sky() -> tuple[np.ndarray, np.ndarray]:
    """The analytic sky set -> (f32 [5, 6, 64, 64, 3] by power, face, ty,
    tx; its cross preview)."""
    sun = np.array([0.577, 0.577, 0.577], dtype=np.float32)
    xs, ys = np.meshgrid(np.arange(CM_W), np.arange(CM_W), indexing="xy")
    dirs = np.stack([_texel_dirs(f, xs, ys) for f in range(6)])

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
        w = 1.0 / (1.0 + p)
        return (sky * (1 - w) + mean * w + sunlobe).astype(np.float32)

    data = np.stack([radiance(dirs, p) for p in POWERS])
    return data, cross_preview(data[0])


ENVMAPS = {"procedural_sky": procedural_sky}

# ---------------------------------------------------------------------------
# Camera paths (rasterizer.rs:417-473): f64 ticks, f32 eyes.
# ---------------------------------------------------------------------------

try:
    _libm = ctypes.CDLL("libm.so.6")
    _libm.cosf.restype = _libm.sinf.restype = ctypes.c_float
    _libm.cosf.argtypes = _libm.sinf.argtypes = [ctypes.c_float]

    def _cosf(x):
        return np.float32(_libm.cosf(float(x)))

    def _sinf(x):
        return np.float32(_libm.sinf(float(x)))
except OSError:  # no glibc: numpy's f32 trig, within an ulp of libm's
    def _cosf(x):
        return np.cos(np.float32(x))

    def _sinf(x):
        return np.sin(np.float32(x))


def _orbit(tick: float) -> np.ndarray:
    return np.array([math.cos(tick / 1.25) * 1.8, 0.0,
                     math.sin(tick / 1.25) * 1.8], dtype=np.float32)


def _orbit_front(tick: float) -> np.ndarray:
    """Dampened front orbit with bobbing: the angle path in f32 per op."""
    f = np.float32
    slow = tick / 3.5
    frac = slow - math.trunc(slow)
    x = f(1.0 - frac) if int(slow) % 2 == 1 else f(frac)
    x = min(max(x, f(0.0)), f(1.0))
    smooth = x * x * x * (x * (x * f(6.0) - f(15.0)) + f(10.0))
    pi = f(math.pi)
    seg = -pi / f(2.0) - (-(pi / f(6.0)) * (f(1.0) - smooth)
                          + (pi / f(6.0)) * smooth)
    return np.array([_cosf(seg), math.sin(tick / 2.0) * 0.25 + 0.2,
                     _sinf(seg)], dtype=np.float32)


CAMERAS = {"orbit": _orbit, "orbit_front": _orbit_front}


def eye(camera: str, tick: float) -> np.ndarray:
    return CAMERAS[camera](tick)

"""Camera animation paths (host-side, tiny per-frame scalar math).

The port's own copy of rustexp_tpu/raster/camera.py. Reference:
rasterizer.rs:417-473 — five eye-position-from-time paths, all looking at
the origin. Computed in float64 and cast to float32 exactly like the
reference's f64 tick -> f32 Point3.
"""

from __future__ import annotations

import math

import numpy as np


def smootherstep(edge0: float, edge1: float, x: float) -> float:
    """Ken Perlin's smootherstep (rasterizer.rs:467-473)."""
    x = min(max((x - edge0) / (edge1 - edge0), 0.0), 1.0)
    return x * x * x * (x * (x * 6.0 - 15.0) + 10.0)


# The reference evaluates cam_orbit_front's angle path entirely in f32
# (rasterizer.rs:434-451: smootherstep is f32, consts::PI here is the f32
# constant, and tick_seg.cos() is f32::cos, which lowers to the C runtime's
# cosf on Linux). Host numpy's float32 trig differs from glibc's cosf by
# 1 ulp on ~40% of inputs (measured), so bind libm directly; parity tests
# anchor camera eyes bit-exactly against the scalar oracle.
try:
    import ctypes

    _libm = ctypes.CDLL("libm.so.6")
    _libm.cosf.restype = ctypes.c_float
    _libm.cosf.argtypes = [ctypes.c_float]
    _libm.sinf.restype = ctypes.c_float
    _libm.sinf.argtypes = [ctypes.c_float]

    def _cosf(x) -> np.float32:
        return np.float32(_libm.cosf(float(x)))

    def _sinf(x) -> np.float32:
        return np.float32(_libm.sinf(float(x)))
except Exception:  # non-glibc host: nearest available f32 trig
    def _cosf(x) -> np.float32:
        return np.cos(np.float32(x))

    def _sinf(x) -> np.float32:
        return np.sin(np.float32(x))


def _smootherstep_f32(x: np.float32) -> np.float32:
    """f32 smootherstep on [0,1] edges, per-op rounding like the reference."""
    f = np.float32
    x = min(max(x, f(0.0)), f(1.0))
    return x * x * x * (x * (x * f(6.0) - f(15.0)) + f(10.0))


def cam_orbit(tick: float) -> np.ndarray:
    return np.array(
        [math.cos(tick / 1.25) * 1.8, 0.0, math.sin(tick / 1.25) * 1.8],
        dtype=np.float32,
    )


def cam_orbit_closer(tick: float) -> np.ndarray:
    return np.array(
        [math.cos(tick / 1.25) * 1.6, 0.0, math.sin(tick / 1.25) * 1.6],
        dtype=np.float32,
    )


def cam_orbit_front(tick: float) -> np.ndarray:
    """Dampened front orbit with vertical bobbing (rasterizer.rs:434-451).

    The angle path is f32 per-op like the reference's: the slow tick and
    the bobbing y stay f64, but smootherstep, the PI/6 segment blend, and
    the final cos/sin all round to f32 at every step.
    """
    f = np.float32
    tick_slow = tick / 3.5
    reverse = int(tick_slow) % 2 == 1
    frac = tick_slow - math.trunc(tick_slow)
    tick_f = f(1.0 - frac) if reverse else f(frac)
    smooth = _smootherstep_f32(tick_f)
    aw = f(1.0) - smooth
    bw = smooth
    pi = f(math.pi)
    tick_seg = -pi / f(2.0) - (-(pi / f(6.0)) * aw + (pi / f(6.0)) * bw)
    return np.array(
        [_cosf(tick_seg), math.sin(tick / 2.0) * 0.25 + 0.2, _sinf(tick_seg)],
        dtype=np.float32,
    )


def cam_pan_front(tick: float) -> np.ndarray:
    return np.array(
        [math.cos(tick) * 0.3, math.sin(tick) * 0.3 + 0.4, 1.7], dtype=np.float32
    )


def cam_pan_back(tick: float) -> np.ndarray:
    return np.array(
        [math.cos(tick) * 0.3, math.sin(tick) * 0.3, -2.0], dtype=np.float32
    )


CAMERAS = {
    "orbit": cam_orbit,
    "orbit_closer": cam_orbit_closer,
    "orbit_front": cam_orbit_front,
    "pan_front": cam_pan_front,
    "pan_back": cam_pan_back,
}


def camera_eye(name: str, tick: float) -> np.ndarray:
    return CAMERAS[name](tick)

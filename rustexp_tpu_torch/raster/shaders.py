"""Shader library, vectorized over fragment batches (shader 5 ported).

Port of rustexp_tpu/raster/shaders.py. A shader maps
``(world_pos, world_normal, baked_color, eye, tick, cm) -> linear RGB``
over arbitrary leading batch dims; ``cm`` is the set's f32
[5, 6, 64, 64, 3] tensor indexed by convolution power {cos^0,1,8,64,512}.

Every chain is written as one torch op per reference operation, so each
product rounds before the add that follows (ops/ieee.py's rule); the JAX
package seals the same chains against XLA:CPU's FMA contraction.

Only CMRefl (index 5, the benchmark's shader) is ported; the other 15
raise NotImplementedError (ROADMAP A5). The name and cubemap flag of
every index are known, so menus and the status line work for all.
"""

from __future__ import annotations

import torch

from ..core.colors import trunc_i32

COS_0, COS_1, COS_8, COS_64, COS_512 = range(5)
CM_FACE_WDH = 64


def _dot(a, b):
    """x*x + y*y + z*z, left to right, per-op f32 -> [..., 1]."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]) \
        + a[..., 2:3] * b[..., 2:3]


def normalize(v):
    """nalgebra normalize: v / sqrt(dot) — DIVISION form (oracle.cpp:57-60)."""
    return v / torch.sqrt(_dot(v, v))


def fast_normalize(v):
    """Reciprocal-MULTIPLY normalize (rasterizer.rs:55-59): v * (1/sqrt)."""
    return v * (1.0 / torch.sqrt(_dot(v, v)))


def reflect(i, n):
    """GLSL-style reflection (rasterizer.rs:61-63)."""
    return i - n * (_dot(n, i) * 2.0)


def normalize_phong_lobe(power: float) -> float:
    return (power + 2.0) * 0.5


def cm_texel_from_dir(d):
    """Direction [..., 3] -> (face, ty, tx) int32 major-axis texel coords
    (rustexp_tpu/raster/shaders.py:65; reference rasterizer.rs:680-713)."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    x_major = (ax > ay) & (ax > az)
    y_major = (ay > ax) & (ay > az)

    face = torch.where(
        x_major, torch.where(dx > 0, 0, 1),
        torch.where(y_major, torch.where(dy > 0, 2, 3),
                    torch.where(dz > 0, 4, 5))).to(torch.int32)
    major = torch.where(x_major, ax, torch.where(y_major, ay, az))
    inv = 1.0 / torch.maximum(major, major.new_tensor(1e-30))
    u = torch.where(x_major, dz, dx) * inv
    v = torch.where(x_major, dy, torch.where(y_major, dz, dy)) * inv
    u = (u + 1.0) * 0.5
    v = (v + 1.0) * 0.5
    tx = trunc_i32(u * CM_FACE_WDH).clamp(0, CM_FACE_WDH - 1)
    ty = trunc_i32(v * CM_FACE_WDH).clamp(0, CM_FACE_WDH - 1)
    return face, ty, tx


def _texel_flat(texel):
    face, ty, tx = texel
    return ((face * CM_FACE_WDH + ty) * CM_FACE_WDH + tx).reshape(-1)


def lookup_texel_cm(cm, power: int, texel):
    """One flat-index row gather into power `power`'s [6*64*64, 3] table."""
    return cm[power].reshape(-1, 3)[_texel_flat(texel)].reshape(
        texel[0].shape + (3,))


def lookup_dir_cm(cm, power: int, d):
    return lookup_texel_cm(cm, power, cm_texel_from_dir(d))


def lookup_texel_powers(cm, powers: tuple, texel):
    """Several convolution powers at one texel with a single row gather."""
    tab = torch.cat([cm[p].reshape(-1, 3) for p in powers], dim=1)
    vals = tab[_texel_flat(texel)].reshape(
        texel[0].shape + (len(powers), 3))
    return tuple(vals[..., i, :] for i in range(len(powers)))


def shader_cm_refl(p, n, col, eye, tick, cm):
    """CMRefl: diffuse cos^1 + phong-normalized cos^8/cos^64 reflections,
    times the squared baked color (rustexp_tpu/raster/shaders.py:195)."""
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c8, c64 = lookup_texel_powers(cm, (COS_8, COS_64), r_tex)
    return (lookup_dir_cm(cm, COS_1, nn)
            + c8 * normalize_phong_lobe(8.0)
            + c64 * normalize_phong_lobe(64.0)) * (col * col)


# (name, uses_cubemap, fn or None while unported) — order matches
# rasterizer.rs:1135-1160.
SHADER_TABLE = tuple(
    (name, uses_cm, shader_cm_refl if name == "CMRefl" else None)
    for name, uses_cm in (
        ("BakedColor", False), ("Normals", False), ("Headlight", False),
        ("Plastic2xDirLight", False), ("CMDiffuse", True), ("CMRefl", True),
        ("CMCoated", True), ("CMDiffRim", True), ("CMGlossy", True),
        ("CMGreenHighlight", True), ("CMRedMaterial", True),
        ("CMMetallic", True), ("CMSuperShiny", True), ("CMGold", True),
        ("CMBlue", True), ("CMBlinnSchlick", True)))

NUM_SHADERS = len(SHADER_TABLE)


def shader_name(idx: int) -> str:
    return SHADER_TABLE[idx][0]


def shader_uses_cm(idx: int) -> bool:
    return SHADER_TABLE[idx][1]


def shader_fn(idx: int):
    name, _, fn = SHADER_TABLE[idx]
    if fn is None:
        raise NotImplementedError(
            f"shader {idx} ({name}) is not ported yet (ROADMAP A5)")
    return fn

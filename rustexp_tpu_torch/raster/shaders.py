"""The 16-shader library, vectorized over fragment batches.

Port of rustexp_tpu/raster/shaders.py (reference rasterizer.rs:816-1164).
A shader maps ``(world_pos, world_normal, baked_color, eye, tick, cm) ->
linear RGB`` over arbitrary leading batch dims; ``cm`` is the set's f32
[5, 6, 64, 64, 3] tensor indexed by convolution power {cos^0,1,8,64,512}.

Every chain is written as one torch op per reference operation, so each
product rounds before the add that follows (ops/ieee.py's rule); the JAX
package seals the same chains against XLA:CPU's FMA contraction. The
sealed CPU forms are kept: ``normalize`` divides, ``fast_normalize`` and
Blinn-Schlick's half vector multiply by a reciprocal, each of a
correctly rounded square root (ops.ieee.sqrt_rn; never ``rsqrt``, whose
last ulp moves point-sampled cubemap texels), and Plastic2xDirLight's
pow16 is core.colors.fast_unit_pow16_arith.
"""

from __future__ import annotations

import functools

import torch

from ..core.colors import fast_unit_pow16_arith, trunc_i32
from ..ops.ieee import sqrt_rn

COS_0, COS_1, COS_8, COS_64, COS_512 = range(5)
CM_FACE_WDH = 64


def _dot(a, b):
    """x*x + y*y + z*z, left to right, per-op f32 -> [..., 1]."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]) \
        + a[..., 2:3] * b[..., 2:3]


def normalize(v):
    """nalgebra normalize: v / sqrt(dot) — DIVISION form (oracle.cpp:57-60)."""
    return v / sqrt_rn(_dot(v, v))


def fast_normalize(v):
    """Reciprocal-MULTIPLY normalize (rasterizer.rs:55-59): v * (1/sqrt)."""
    return v * (1.0 / sqrt_rn(_dot(v, v)))


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
    inv = 1.0 / major.clamp(min=1e-30)  # no host constant to copy
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


@functools.cache
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """An f32 constant vector on `device`, copied there once."""
    return torch.tensor(values, dtype=torch.float32).to(device)


def fresnel_conductor(cosi, eta: float, k: float):
    """PBRT 1st-edition conductor Fresnel (rasterizer.rs:1033-1056)."""
    tmp = (eta * eta + k * k) * cosi * cosi
    x = 2.0 * eta * cosi
    r_par2 = (tmp - x + 1.0) / (tmp + x + 1.0)
    tmp_f = eta * eta + k * k
    cc = cosi * cosi
    r_per2 = (tmp_f - x + cc) / (tmp_f + x + cc)
    return (r_par2 + r_per2) * 0.5


# ---------------------------------------------------------------------------
# Shaders (rustexp_tpu/raster/shaders.py:153-334). Signature:
# (p, n, col, eye, tick, cm) -> rgb, all [..., 3].
# ---------------------------------------------------------------------------


def shader_color(p, n, col, eye, tick, cm):
    return col


def shader_n_to_color(p, n, col, eye, tick, cm):
    return (normalize(n) + 1.0) * 0.5


def shader_headlight(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    l = fast_normalize(eye - p)
    ldotn = _dot(l, nn).clamp(0.0, 1.0)
    return col * col * ldotn


def shader_dir_light(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r = fast_normalize(reflect(p - eye, nn))
    l = _const((0.577350269,) * 3, p.device)

    def one_light(lv):
        ldotn = _dot(lv, nn).clamp(0.0, 1.0)
        ldotr = fast_unit_pow16_arith(_dot(lv, r).clamp(0.0, 1.0))
        return ldotn * 0.25 + ldotr * 0.75

    light = (_const((1.0, 0.5, 0.5), p.device) * one_light(l)
             + _const((0.5, 0.5, 1.0), p.device) * one_light(-l)
             + _const((0.05, 0.05, 0.05), p.device))
    return light * (col * col)


def shader_cm_diffuse(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    return lookup_dir_cm(cm, COS_1, nn) * (col * col)


def shader_cm_refl(p, n, col, eye, tick, cm):
    """CMRefl: diffuse cos^1 + phong-normalized cos^8/cos^64 reflections,
    times the squared baked color (rustexp_tpu/raster/shaders.py:195)."""
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c8, c64 = lookup_texel_powers(cm, (COS_8, COS_64), r_tex)
    return (lookup_dir_cm(cm, COS_1, nn)
            + c8 * normalize_phong_lobe(8.0)
            + c64 * normalize_phong_lobe(64.0)) * (col * col)


def shader_cm_coated(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    eyev = p - eye
    r_tex = cm_texel_from_dir(reflect(eyev, nn))
    fres = fresnel_conductor(_dot(-eyev, nn), 1.0, 1.1)
    c8, c512 = lookup_texel_powers(cm, (COS_8, COS_512), r_tex)
    return (lookup_dir_cm(cm, COS_1, nn) * 0.85
            + c8 * normalize_phong_lobe(8.0) * fres
            + c512 * normalize_phong_lobe(512.0) * fres * 1.5) * (col * col)


def shader_cm_diff_rim(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    fres = fresnel_conductor(_dot(-(p - eye), nn), 1.0, 1.1)
    return (lookup_dir_cm(cm, COS_1, nn) + fres * 0.75) * col


def shader_cm_glossy(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r = reflect(p - eye, nn)
    return (lookup_dir_cm(cm, COS_1, nn)
            + lookup_dir_cm(cm, COS_8, r) * normalize_phong_lobe(8.0)
            ) * (col * col)


def shader_cm_green_highlight(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r = reflect(p - eye, nn)
    return (lookup_dir_cm(cm, COS_1, nn)
            + lookup_dir_cm(cm, COS_64, r) * normalize_phong_lobe(64.0)
            * _const((0.2, 0.8, 0.2), p.device)) * (col * col)


def shader_cm_red_material(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r = reflect(p - eye, nn)
    return (lookup_dir_cm(cm, COS_1, nn) * _const((0.8, 0.2, 0.2), p.device)
            + lookup_dir_cm(cm, COS_512, r) * normalize_phong_lobe(512.0)
            ) * (col * col)


def shader_cm_metallic(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c8, c64 = lookup_texel_powers(cm, (COS_8, COS_64), r_tex)
    return (c8 * normalize_phong_lobe(8.0)
            + c64 * normalize_phong_lobe(64.0)) * col


def shader_cm_super_shiny(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c64, c512, c0 = lookup_texel_powers(cm, (COS_64, COS_512, COS_0), r_tex)
    return (c64 * normalize_phong_lobe(64.0)
            + c512 * normalize_phong_lobe(512.0) + c0) * col


def shader_cm_gold(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    l = fast_normalize(eye - p)
    ldotn = _dot(l, nn).clamp(0.0, 1.0)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c8, c512 = lookup_texel_powers(cm, (COS_8, COS_512), r_tex)
    return (lookup_dir_cm(cm, COS_1, nn) * ldotn
            + c8 * normalize_phong_lobe(8.0)
            + c512 * normalize_phong_lobe(512.0) * (1.0 - ldotn)
            ) * _const((1.0, 0.76, 0.33), p.device) * (col * col)


def shader_cm_blue(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    l = fast_normalize(eye - p)
    ldotn = _dot(l, nn).clamp(0.0, 1.0)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c64, c512 = lookup_texel_powers(cm, (COS_64, COS_512), r_tex)
    return (lookup_dir_cm(cm, COS_1, nn) * _const((0.2, 0.2, 0.8), p.device)
            * ldotn
            + c64 * normalize_phong_lobe(64.0) * 0.75
            + c512 * normalize_phong_lobe(512.0) * (1.0 - ldotn)
            ) * (col * col)


def shader_cm_blinn_schlick(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    eyev = p - eye
    r = reflect(eyev, nn)
    # The reference's half vector is (n + r) * (1 / |n + r|), and the
    # Schlick weight takes the unnormalized eye vector (rasterizer.rs:
    # 1023-1025).
    nr = nn + r
    h = nr * (1.0 / sqrt_rn(_dot(nr, nr)))
    w = 1.0 - _dot(h, eyev).clamp(0.0, 1.0)
    w = w * w
    return (lookup_dir_cm(cm, COS_1, nn) * _const((0.8, 0.65, 1.0), p.device)
            * w
            + lookup_dir_cm(cm, COS_64, h) * normalize_phong_lobe(64.0)
            * (1.25 - w)) * (col * col)


# (name, uses_cubemap, fn) — order matches rasterizer.rs:1135-1160.
SHADER_TABLE = (
    ("BakedColor", False, shader_color),
    ("Normals", False, shader_n_to_color),
    ("Headlight", False, shader_headlight),
    ("Plastic2xDirLight", False, shader_dir_light),
    ("CMDiffuse", True, shader_cm_diffuse),
    ("CMRefl", True, shader_cm_refl),
    ("CMCoated", True, shader_cm_coated),
    ("CMDiffRim", True, shader_cm_diff_rim),
    ("CMGlossy", True, shader_cm_glossy),
    ("CMGreenHighlight", True, shader_cm_green_highlight),
    ("CMRedMaterial", True, shader_cm_red_material),
    ("CMMetallic", True, shader_cm_metallic),
    ("CMSuperShiny", True, shader_cm_super_shiny),
    ("CMGold", True, shader_cm_gold),
    ("CMBlue", True, shader_cm_blue),
    ("CMBlinnSchlick", True, shader_cm_blinn_schlick),
)

NUM_SHADERS = len(SHADER_TABLE)


def shader_name(idx: int) -> str:
    return SHADER_TABLE[idx][0]


def shader_uses_cm(idx: int) -> bool:
    return SHADER_TABLE[idx][1]


def shader_fn(idx: int):
    return SHADER_TABLE[idx][2]

"""Color packing, gamma correction and fast-power LUTs.

Port of rustexp_tpu/core/colors.py (same reference conventions: ABGR32,
``pixel = R | G<<8 | B<<16 | A<<24``, bottom-left origin). The numpy LUT
builders are copied, not imported: importing the JAX module would pull
jax in.

Packed pixels are int32 tensors holding the uint32 ABGR bits: torch has
no shifts or index_put for uint32, so the frame is built in int32 and
reinterpreted (``.view(torch.uint32)``) only where it is handed out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# LUT construction (host-side, numpy, float32 to match the generators)
# ---------------------------------------------------------------------------


def _make_gamma_lut() -> np.ndarray:
    """11-bit gamma-2.2 LUT: round((i/2047)^(1/2.2) * 255) for i in [0, 2048).

    rustexp_tpu/core/colors.py:24 (reference rasterizer.rs:1389-1510).
    """
    i = np.arange(2048, dtype=np.float32)
    v = np.power(i / np.float32(2047.0), np.float32(1.0 / 2.2), dtype=np.float32)
    return np.round(v * np.float32(255.0)).astype(np.uint8)


def _make_pow16_table() -> np.ndarray:
    """256-entry shifted x^16 table: ((600+i)/855)^16 for i in [0, 256).

    rustexp_tpu/core/colors.py:35 (reference rasterizer.rs:1058-1127).
    """
    i = np.arange(256, dtype=np.float32) + np.float32(600.0)
    v = i / np.float32(855.0)
    return np.power(v, np.float32(16.0), dtype=np.float32)


GAMMA_11BIT_LUT = _make_gamma_lut()           # uint8 [2048]
POW16_TABLE = _make_pow16_table()             # float32 [256]


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero, saturating, NaN -> 0.

    XLA's convert saturates (and the CUDA cvt.rzi does), while torch's CPU
    cast of an out-of-range float is undefined; this pins one answer on
    every device.
    """
    big = x >= 2147483648.0
    safe = torch.where(torch.isnan(x) | big, 0.0, x).clamp(min=-2147483648.0)
    return torch.where(big, 2147483647, safe.to(torch.int32))


@functools.cache
def _gamma_curve(device: torch.device) -> torch.Tensor:
    """The arithmetic gamma curve at every 11-bit index, evaluated once.

    The formula's input takes only 2048 values, so evaluating it on the
    host in torch and gathering gives the formula's exact results on any
    device (a CUDA powf may differ from the CPU's in the last ulp).
    """
    x = torch.arange(2048, dtype=torch.float32) * np.float32(1.0 / 2047.0)
    v = torch.round(torch.pow(x, np.float32(1.0 / 2.2)) * 255.0)
    return v.to(torch.int32).to(device)


# ---------------------------------------------------------------------------
# Packing (elementwise over tensors of any shape)
# ---------------------------------------------------------------------------


def pack_abgr32(r, g, b):
    """Clamp to [0,1], scale by 255, truncate, pack. No gamma.

    rustexp_tpu/core/colors.py:73 (reference rasterizer.rs:1337-1345).
    """
    r8 = trunc_i32(r.clamp(0.0, 1.0) * 255.0)
    g8 = trunc_i32(g.clamp(0.0, 1.0) * 255.0)
    b8 = trunc_i32(b.clamp(0.0, 1.0) * 255.0)
    return r8 | (g8 << 8) | (b8 << 16)


def pack_abgr32_gamma_arith(r, g, b):
    """Gamma-2.2 pack: round(255 * (trunc(v*2047)/2047)^(1/2.2)).

    rustexp_tpu/core/colors.py:104. Keeps the reference's quirk that the
    blue channel's negative test reads the RED index (rasterizer.rs:1376).
    """
    ri = trunc_i32(r * 2047.0)
    gi = trunc_i32(g * 2047.0)
    bi = trunc_i32(b * 2047.0)
    curve = _gamma_curve(ri.device)

    def chan(i, neg):
        v = curve[i.clamp(0, 2047)]
        return torch.where(neg, 0, torch.where(i > 2047, 255, v))

    return (chan(ri, ri < 0) | (chan(gi, gi < 0) << 8)
            | (chan(bi, ri < 0) << 16))


def fast_unit_pow16_arith(v):
    """fast_unit_pow16's LUT semantics via four squarings.

    rustexp_tpu/core/colors.py:131 (reference rasterizer.rs:1060-1070).
    """
    idx = trunc_i32(v * 855.0 - 600.0)
    x = (idx.clamp(0, 255).to(torch.float32) + 600.0) * np.float32(1.0 / 855.0)
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    val = x8 * x8
    return torch.where(idx < 0, 0.0, torch.where(idx > 255, 1.0, val))


def pack_abgr32_gamma_np(rgb: np.ndarray) -> np.ndarray:
    """Host-side numpy gamma pack for asset preprocessing.

    rustexp_tpu/core/colors.py:147: rgb float32 [..., 3] -> uint32 [...]
    ABGR (alpha 0), same 11-bit LUT and blue-channel quirk.
    """
    i = (rgb.astype(np.float32) * np.float32(2047.0)).astype(np.int32)
    ri, gi, bi = i[..., 0], i[..., 1], i[..., 2]

    def lut(idx):
        return GAMMA_11BIT_LUT[np.clip(idx, 0, 2047)].astype(np.uint32)

    r8 = np.where(ri < 0, np.uint32(0), np.where(ri > 2047, np.uint32(255), lut(ri)))
    g8 = np.where(gi < 0, np.uint32(0), np.where(gi > 2047, np.uint32(255), lut(gi)))
    b8 = np.where(ri < 0, np.uint32(0), np.where(bi > 2047, np.uint32(255), lut(bi)))
    return (r8 | (g8 << 8) | (b8 << 16)).astype(np.uint32)


def _bits(c: torch.Tensor) -> torch.Tensor:
    """A packed-pixel tensor's bits as int32 (uint32 frames are viewed)."""
    return c.view(torch.int32) if c.dtype == torch.uint32 else c.to(torch.int32)


def unpack_abgr32(c: torch.Tensor):
    """ABGR32 -> (r, g, b, a) int32 channels in [0, 255]
    (rustexp_tpu/core/colors.py:165). The masks make int32's arithmetic
    shift a logical one."""
    c = _bits(c)
    return c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF, (c >> 24) & 0xFF


def add_abgr32(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Per-channel saturating add of two ABGR32 values -> uint32
    (rustexp_tpu/core/colors.py:171; reference add_abgr32,
    nbody.rs:595-617)."""
    r1, g1, b1, a1 = unpack_abgr32(c1)
    r2, g2, b2, a2 = unpack_abgr32(c2)
    r, g, b, a = ((x + y).clamp(max=255)
                  for x, y in ((r1, r2), (g1, g2), (b1, b2), (a1, a2)))
    return ((a << 24) | (b << 16) | (g << 8) | r).view(torch.uint32)


def abgr32_to_rgb8(fb_u32: np.ndarray) -> np.ndarray:
    """Host-side: a uint32 ABGR framebuffer [h, w] -> uint8 RGB [h, w, 3]
    (rustexp_tpu/core/colors.py:204)."""
    fb = np.asarray(fb_u32, dtype=np.uint32)
    out = np.empty(fb.shape + (3,), dtype=np.uint8)
    out[..., 0] = fb & 0xFF
    out[..., 1] = (fb >> 8) & 0xFF
    out[..., 2] = (fb >> 16) & 0xFF
    return out

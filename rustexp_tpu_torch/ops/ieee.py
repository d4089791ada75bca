"""Per-op f32 rounding: the port's rounding rule, written down once.

Port of rustexp_tpu/ops/ieee.py. The reference rounds every f32 operation
once (no FMA contraction). The JAX package forces that on XLA:CPU, whose
LLVM codegen contracts mul->add chains, by laundering each product
through integer ops (``seal``). Eager PyTorch launches one kernel per
operator and each rounds its result, so ``seal`` is the identity here and
``lerp_2mad``/``lerp_3w`` are plain expressions. The rule that keeps them
exact, on the CPU and on the card:

  * No ``torch.addcmul``, ``torch.lerp``, ``@``, ``einsum`` or
    ``torch.compile`` on a sealed chain: they fuse or reorder the adds.
  * No ``torch.rsqrt``: normalize is ``v / sqrt(dot)`` or
    ``v * (1 / sqrt(dot))`` exactly as written (docs/PARITY.md: a
    last-ulp rsqrt moved cubemap texels on 3-26% of per-pixel pixels),
    with ``sqrt_rn`` for the square root.
  * CUDA C++ is built with ``-fmad=false`` (runtime.NVCC_FLAGS); a kernel
    that must be built otherwise uses ``__fmul_rn``/``__fadd_rn`` at
    every sealed site.
"""

from __future__ import annotations

import math

import torch

# Taylor coefficients of sin(r) / r and cos(r) in r**2 on |r| <= pi/4; the
# first term left out is below 2**-60 of the result.
_SIN = tuple((-1) ** i / math.factorial(2 * i + 1) for i in range(10))
_COS = tuple((-1) ** i / math.factorial(2 * i) for i in range(10))
# pi/2 in two parts (fdlibm's pio2_1, pio2_1t): the first 33 bits, so that
# k * _PIO2_HI is exact for |k| < 2**20, and the rest.
_PIO2_HI = 1.57079632673412561417e+00
_PIO2_LO = 6.07710050650619224932e-11


def cos_sin(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 cos and sin of a float32 tensor (|theta| < 2**20), the same
    bits on the CPU and the card: the libraries' cos and sin differ by
    device, so the reduction to |r| <= pi/4 and the polynomials are plain
    float64 adds and multiplies, each rounded once on both devices, and
    the results are rounded once to float32 (within an ulp of the true
    value)."""
    t = theta.double()
    k = torch.round(t * (2.0 / math.pi))
    r = (t - k * _PIO2_HI) - k * _PIO2_LO
    z = r * r
    ps, pc = z.new_full((), _SIN[-1]), z.new_full((), _COS[-1])
    for cs, cc in zip(_SIN[-2::-1], _COS[-2::-1]):
        ps = ps * z + cs
        pc = pc * z + cc
    s, c = r * ps, pc
    q = k.to(torch.int64) % 4
    swap = (q & 1) == 1
    c0, s0 = torch.where(swap, s, c), torch.where(swap, c, s)
    cos = torch.where((q == 1) | (q == 2), -c0, c0)
    sin = torch.where(q >= 2, -s0, s0)
    return cos.float(), sin.float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA:CPU's and the
    reference's. The card's torch.sqrt is (CUDA's IEEE sqrtf). The CPU's
    vectorized torch.sqrt is not: it is one ulp off on some elements of
    large tensors (torch 2.13, AVX-512), so the CPU takes the root in
    float64 and rounds once to f32, which is exact for a square root
    (53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def lerp_2mad(q0, q10, q20, b2, b0):
    """(q0 + q10*b2) + q20*b0, each op rounded — the reference's 2-MAD
    attribute form (z, 1/w, colors; rasterizer.rs:1656-1663, 1695-1719).
    rustexp_tpu/ops/ieee.py:89."""
    return q0 + q10 * b2 + q20 * b0


def lerp_3w(qb1, qb2, qb0, b1, b2, b0):
    """(qb1*b1 + qb2*b2) + qb0*b0, each op rounded — the three-weight form
    (world pos, normals; rasterizer.rs:1725-1733). rustexp_tpu/ops/ieee.py:96."""
    return qb1 * b1 + qb2 * b2 + qb0 * b0

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
    last-ulp rsqrt moved cubemap texels on 3-26% of per-pixel pixels).
  * CUDA C++ is built with ``-fmad=false`` (runtime.NVCC_FLAGS); a kernel
    that must be built otherwise uses ``__fmul_rn``/``__fadd_rn`` at
    every sealed site.
"""

from __future__ import annotations


def lerp_2mad(q0, q10, q20, b2, b0):
    """(q0 + q10*b2) + q20*b0, each op rounded — the reference's 2-MAD
    attribute form (z, 1/w, colors; rasterizer.rs:1656-1663, 1695-1719).
    rustexp_tpu/ops/ieee.py:89."""
    return q0 + q10 * b2 + q20 * b0


def lerp_3w(qb1, qb2, qb0, b1, b2, b0):
    """(qb1*b1 + qb2*b2) + qb0*b0, each op rounded — the three-weight form
    (world pos, normals; rasterizer.rs:1725-1733). rustexp_tpu/ops/ieee.py:96."""
    return qb1 * b1 + qb2 * b2 + qb0 * b0

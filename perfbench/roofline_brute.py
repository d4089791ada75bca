"""The least time of one exact all-pairs step's forces on one H100, at
perfbench/roofline_nbody.py's rates and term costs, unchanged.

The work is the configuration's, never kernel B5's plan or launches, so
no implementation can read above 100%:

* pairs: N (N - 1) / 2 mutual pairs, since a kernel may spend one
  reciprocal and one softened square on both sides of a pair;
* reciprocals: one a pair, on the SFU (4.18e12/s);
* FP32 instructions on the 128 FP32 lanes of an SM (3.35e13/s): 10 a
  mutual pair (two differences, the softened square in two FMAs, two
  masses over it, four FMAs into the two bodies' sums);
* bytes: the state (x, y, vx, vy, m, f32) read once and the two force
  components written once, at 3.35 TB/s.

The bound is the largest of the three: FP32 at any N that fills the card
(2.568 ms at N 131,072).
"""

from __future__ import annotations

from .roofline import FP32_NON_FMA_OPS_PER_S, HBM_BYTES_PER_S
from .roofline_nbody import FORCE_WORDS, FP32_PER_HALF_PAIR, RCP_PER_S, \
    STATE_WORDS


def pairs(n: int) -> float:
    """Mutual pairs of n bodies."""
    return n * (n - 1) / 2


def force_bound_s(cfg: dict) -> tuple[float, str]:
    """(least seconds of one step's all-pairs forces, "reciprocals",
    "fp32" or "bytes") for the configuration `cfg`."""
    p = pairs(cfg["n"])
    t = {"reciprocals": p / RCP_PER_S,
         "fp32": p * 2 * FP32_PER_HALF_PAIR / FP32_NON_FMA_OPS_PER_S,
         "bytes": cfg["n"] * 4 * (STATE_WORDS + FORCE_WORDS)
         / HBM_BYTES_PER_S}
    by = max(t, key=t.get)
    return t[by], by

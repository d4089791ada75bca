"""The least time of one Game of Life step on one H100, at
perfbench/roofline.py's rates.

The work is the configuration's, never kernel B4's plan: n^2 cells
packed 32 to a word (bit b of word [w, c] is cell [32w + b, c]), so
(n / 32) n words, each stepped ``steps_per_frame`` generations. No halo
recompute, no exchange between threads (shuffles, shared memory,
selects) and no relaunch is counted, so no implementation can read above
100%.

* operations: a word and generation costs the gates of the circuit
  below, each one instruction of the integer pipe (64 lanes an SM:
  1.67e13/s): a funnel shift (SHF) or a logic op of three inputs (LOP3,
  any truth table);
* bytes: the packed grid read once and written once a step, at
  3.35 TB/s.

The bound is the larger: the operations at any size (6.02 us a step at
2048^2 and 64 generations, against 0.31 us of bytes).

The circuit, 12 gates a word and generation. Inputs: the word p, the
words a above and b below it in its column (rows 32w - 32 .. 32w - 1 and
32w + 32 .. 32w + 63), and the vertical sums (s0, s1) that the columns
to the left (l0, l1) and right (r0, r1) computed in their gates 3 and 4.

  1. up = SHF.L(a, p, 1) = p << 1 | a >> 31    the cell above each cell
  2. dn = SHF.R(p, b, 1) = p >> 1 | b << 31    the cell below
  3. s0 = LOP3 up ^ p ^ dn                     the column's 3-sum, 1s bit
  4. s1 = LOP3 maj(up, p, dn)                  its 2s bit
  5. b0 = LOP3 l0 ^ s0 ^ r0                    the 3x3 box count's 1s bit
  6. c0 = LOP3 maj(l0, s0, r0)                 its carry into the 2s
  7. t0 = LOP3 l1 ^ s1 ^ r1                    l1 + s1 + r1 = t0 + 2 t1
  8. t1 = LOP3 maj(l1, s1, r1)
  9. e1 = LOP3 (t0 ^ c0) & ~t1                 the 2s, t0 + c0 + 2 t1, == 1
 10. e2 = LOP3 ~(t0 ^ c0) & (t0 ^ t1)          the 2s == 2
 11. k4 = LOP3 p & e2 & ~b0                    alive and box == 4
 12. next = LOP3 (b0 & e1) | k4                box == 3, or alive and 4

The box count takes in the cell itself, so ``box == 3 || (alive && box
== 4)`` is upstream's ``alive_nb == 3 || (alive && alive_nb == 2)``
(gol.rs:79). Kernel B4 spends 18 (its SASS: 2 SHF and 16 LOP3 in the
generation loop) and its exchange besides. An exhaustive search over
three-gate circuits found none for gates 9-12 from (b0, p, t0, c0, t1).
"""

from __future__ import annotations

import numpy as np

from .roofline import HBM_BYTES_PER_S, INT_OPS_PER_S

BITS = 32
WORD_BYTES = 4


def _lop3(fn):
    """A LOP3 gate: fn's truth table over three inputs, index 4a + 2b + c."""
    table = sum((fn(x, y, z) & 1) << (4 * x + 2 * y + z)
                for x in (0, 1) for y in (0, 1) for z in (0, 1))
    return ("lop3", table)


SHF_L = ("shf", "l")  # funnel shift left by one: (hi << 1) | (lo >> 31)
SHF_R = ("shf", "r")  # funnel shift right by one: (lo >> 1) | (hi << 31)
XOR3 = _lop3(lambda x, y, z: x ^ y ^ z)
MAJ = _lop3(lambda x, y, z: (x & y) | (z & (x ^ y)))

# (output, gate, inputs), in order; a gate's inputs are earlier outputs
# or the circuit's inputs p, a, b, l0, l1, r0, r1
VERTICAL = [
    ("up", SHF_L, ("a", "p")),
    ("dn", SHF_R, ("p", "b")),
    ("s0", XOR3, ("up", "p", "dn")),
    ("s1", MAJ, ("up", "p", "dn")),
]
HORIZONTAL = [
    ("b0", XOR3, ("l0", "s0", "r0")),
    ("c0", MAJ, ("l0", "s0", "r0")),
    ("t0", XOR3, ("l1", "s1", "r1")),
    ("t1", MAJ, ("l1", "s1", "r1")),
    ("e1", _lop3(lambda t0, c0, t1: (t0 ^ c0) & ~t1), ("t0", "c0", "t1")),
    ("e2", _lop3(lambda t0, c0, t1: ~(t0 ^ c0) & (t0 ^ t1)),
     ("t0", "c0", "t1")),
    ("k4", _lop3(lambda p, e2, b0: p & e2 & ~b0), ("p", "e2", "b0")),
    ("next", _lop3(lambda b0, e1, k4: (b0 & e1) | k4), ("b0", "e1", "k4")),
]
GATES_PER_WORD = len(VERTICAL) + len(HORIZONTAL)


def _gate(gate, args):
    kind, how = gate
    if kind == "shf":
        lo, hi = args
        return ((hi << 1) | (lo >> 31)) if how == "l" \
            else ((lo >> 1) | (hi << 31))
    out = np.zeros_like(args[0])
    for i in range(8):
        if how >> i & 1:
            term = ~np.zeros_like(out)
            for j, x in enumerate(args):
                term &= x if (i >> (2 - j)) & 1 else ~x
            out |= term
    return out


def _run(gates, env):
    for name, gate, ins in gates:
        env[name] = _gate(gate, [env[x] for x in ins])
    return env


def generation(words: np.ndarray) -> np.ndarray:
    """One generation of a packed uint32 [W, C] grid on the torus, gate by
    gate through the circuit above."""
    p = np.asarray(words, dtype=np.uint32)
    v = _run(VERTICAL, {"p": p, "a": np.roll(p, 1, 0),
                        "b": np.roll(p, -1, 0)})
    env = {**v, "l0": np.roll(v["s0"], 1, 1), "l1": np.roll(v["s1"], 1, 1),
           "r0": np.roll(v["s0"], -1, 1), "r1": np.roll(v["s1"], -1, 1)}
    return _run(HORIZONTAL, env)["next"]


def words(n: int) -> int:
    """Packed words of an n x n grid."""
    return n // BITS * n


def step_bound_s(cfg: dict) -> tuple[float, str]:
    """(least seconds of one step of the configuration `cfg`,
    "operations" or "bytes")."""
    w = words(cfg["n"])
    t = {"operations": w * cfg["steps_per_frame"] * GATES_PER_WORD
         / INT_OPS_PER_S,
         "bytes": 2 * w * WORD_BYTES / HBM_BYTES_PER_S}
    by = max(t, key=t.get)
    return t[by], by

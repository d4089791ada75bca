"""jax.random's threefry2x32, as far as the JAX package draws from it.

Port of the ``jax.random`` functions the JAX package calls (``PRNGKey``,
``split``, ``uniform``, ``bernoulli``) in their default form: the
threefry2x32 generator with ``jax_threefry_partitionable`` on (JAX's
default), 32-bit keys and float32 draws. The same key gives the same
words as JAX, bit for bit, on the CPU and on the card.

A key is a CPU tensor of two uint32 words, ``[hi, lo]``, as JAX's raw
``uint32[2]`` key: ``key.numpy()`` is the array a JAX checkpoint holds.
Draws land on the ``device`` they are asked for (the card by default).
torch has no add or shift for uint32, so the words are computed in int64
and masked to 32 bits; ``random_bits`` returns them so.

Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011): 20 rounds of add, rotate and xor over a pair of 32-bit
words, the key injected every 4 rounds. Each draw's counter is its
row-major flat index as (hi, lo) words; ``split`` draws the pair of
output words of counters 0..num-1, the bits are the xor of the pair.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import device as pick_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words [0, seed & 0xFFFFFFFF]. JAX
    takes a Python int through int64, so any int of that range keys by
    its low 32 bits (PRNGKey(-1) == PRNGKey(2**32 - 1))."""
    seed = int(np.int64(seed))  # OverflowError past int64, as JAX
    return as_key((0, seed & MASK))


def as_key(words) -> torch.Tensor:
    """A key from two uint32 words: a key tensor, or the numpy array of a
    JAX key or of a checkpoint."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().to(torch.int64).tolist()
    a = np.asarray(words).astype(np.int64)
    if a.shape != (2,) or a.min() < 0 or a.max() > MASK:
        raise ValueError(f"a PRNG key is two uint32 words, got {a!r}")
    return torch.from_numpy(a.astype(np.uint32))


def _words(k: torch.Tensor) -> tuple[int, int]:
    if k.shape != (2,):
        raise ValueError(f"a PRNG key has shape (2,), got {tuple(k.shape)}")
    hi, lo = k.to(torch.int64).tolist()
    return hi, lo


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k: tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair of output words of counters (x0, x1) under key words k:
    int64 tensors holding uint32 words in, the same out."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK
    return x0, x1


def _counters(n: int, dev: torch.device):
    flat = torch.arange(n, dtype=torch.int64, device=dev)
    return flat >> 32, flat & MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: `num` new keys, uint32 [num, 2] on the CPU."""
    out0, out1 = threefry2x32(_words(k), *_counters(num, torch.device("cpu")))
    return torch.stack([out0, out1], dim=1).to(torch.uint32)


def random_bits(k: torch.Tensor, shape,
                device: torch.device | str | None = None) -> torch.Tensor:
    """JAX's 32-bit random bits of `shape` (its partitionable layout), as
    int64 words in [0, 2**32) on `device` (the card by default)."""
    dev = pick_device(device)
    shape = tuple(int(s) for s in shape)
    out0, out1 = threefry2x32(_words(k), *_counters(int(np.prod(shape)), dev))
    return (out0 ^ out1).reshape(shape)


def uniform(k: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0,
            device: torch.device | str | None = None) -> torch.Tensor:
    """jax.random.uniform in float32 on `device`: the bits' top 23 as the
    mantissa of a float in [1, 2), minus 1, then scaled to [minval,
    maxval). XLA:CPU contracts JAX's ``f * (maxval - minval) + minval``
    into one FMA, so it is rounded once here: the product and the sum in
    float64, exact for the bounds the JAX package draws with (the test
    suite checks the bit span), then rounded to float32."""
    bits = random_bits(k, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = mant - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    if (lo, hi) == (0.0, 1.0):
        return f
    span = float(hi - lo)  # a float32 subtraction, as JAX's
    scaled = (f.double() * span + float(lo)).float()
    return torch.maximum(scaled, scaled.new_full((), float(lo)))


def bernoulli(k: torch.Tensor, p: float, shape,
              device: torch.device | str | None = None) -> torch.Tensor:
    """jax.random.bernoulli: bool `shape` on `device`, uniform < p."""
    u = uniform(k, shape, device=device)
    return u < u.new_full((), float(np.float32(p)))

"""Bit-packed (SWAR) Game of Life, 32 cells per word, and kernel B4.

Port of rustexp_tpu/ops/gol_bits.py. Same semantics as ops/gol_stencil.py
(reference gol_step, rs-src/gol.rs:31-170), but cells are bits: word
``P[w, c]`` bit ``b`` holds ``cell[32*w + b, c]``, and the neighbour count
runs as carry-save adder logic on whole words. Exact, so bit-identical to
step_roll and step_mxu.

Kernel B4 (csrc/gol_swar.cu, replacing ``_swar_kernel``) runs k
generations for CUDA tensors; multi_step_packed_plain, built on
``_gen_bits``, is its plain version and serves CPU tensors. B4 has two
forms, which ``_b4_plan`` picks from the packed grid's size: small grids
stay in registers for all k generations in one launch, any other
32-row-aligned size is stepped on tiles with whole-word halos. The JAX
package's VMEM model (MAX_CELLS, pick_band, pick_plan, the banded and
chained forms) has no counterpart here.

Packed grids are torch.uint32 at the public functions, as JAX returns
uint32; inside they are int32 words with the same bits (torch has no
shifts for uint32). int32 ``>>`` is arithmetic, so right shifts are
masked to stay logical.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..runtime import load_kernel_lib, ptr, stream_ptr

BITS = 32
_LOW31 = 0x7FFFFFFF


def _words(packed: torch.Tensor) -> torch.Tensor:
    """The int32 view of a uint32 or int32 packed grid."""
    if packed.dtype == torch.uint32:
        return packed.view(torch.int32)
    if packed.dtype != torch.int32:
        raise ValueError(f"packed grid must be uint32 or int32, got "
                         f"{packed.dtype}")
    return packed


def pack_rows(grid: torch.Tensor) -> torch.Tensor:
    """[R, C] {0,1} int grid -> [R//32, C] uint32, bit b = row 32w+b."""
    r, c = grid.shape
    if r % BITS:
        raise ValueError(f"rows {r} not a multiple of {BITS}")
    g = grid.to(torch.int64).reshape(r // BITS, BITS, c)
    w = torch.ones((), dtype=torch.int64, device=grid.device) << torch.arange(
        BITS, dtype=torch.int64, device=grid.device)
    words = (g * w[None, :, None]).sum(dim=1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).view(torch.uint32)


def unpack_rows(packed: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """[W, C] uint32 -> [32*W, C] {0,1} of `dtype`."""
    p = _words(packed)
    wn, c = p.shape
    b = torch.arange(BITS, dtype=torch.int32, device=p.device)
    bits = (p[:, None, :] >> b[None, :, None]) & 1  # bit b, sign or not
    return bits.to(dtype).reshape(wn * BITS, c)


def _gen_bits(p: torch.Tensor) -> torch.Tensor:
    """One generation on the int32 packed grid (torus), as the TPU kernel
    computes it (rustexp_tpu/ops/gol_bits.py:54-98): the vertical 3-sum
    as a 2-bit carry-save (s1, s0), the horizontal sum of three of those
    as the 4-bit box count (b3..b0), and the rule in box form,
    ``box == 3 || (alive && box == 4)``."""
    # Row neighbours: bit b of `up` is cell[32w+b-1], the row above.
    up = (p << 1) | ((torch.roll(p, 1, 0) >> 31) & 1)
    down = ((p >> 1) & _LOW31) | (torch.roll(p, -1, 0) << 31)
    s0 = up ^ p ^ down
    s1 = (up & p) | (down & (up ^ p))
    l0, l1 = torch.roll(s0, 1, 1), torch.roll(s1, 1, 1)
    r0, r1 = torch.roll(s0, -1, 1), torch.roll(s1, -1, 1)
    b0 = l0 ^ s0 ^ r0
    c0 = (l0 & s0) | (r0 & (l0 ^ s0))
    sa, ca = l1 ^ s1, l1 & s1
    sb, cb = r1 ^ c0, r1 & c0
    b1, c2 = sa ^ sb, sa & sb
    b2 = ca ^ cb ^ c2
    b3 = (ca & cb) | (c2 & (ca ^ cb))
    eq3 = b0 & b1 & ~(b2 | b3)
    eq4 = b2 & ~(b0 | b1 | b3)
    return eq3 | (p & eq4)


def multi_step_packed_plain(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: k generations of ``_gen_bits``
    on a packed [W, C] grid -> int32 words."""
    p = _words(packed)
    for _ in range(int(k)):
        p = _gen_bits(p)
    return p


RESIDENT_MAX_ROWS = 8        # form (a): word rows a thread holds
RESIDENT_MAX_THREADS = 1024  # form (a): columns, one thread each
# form (a) runs on one SM, so past some size the tiles on many SMs are
# faster: an H100 took 0.52 us a generation resident against 0.55 tiled
# at 256^2 (2,048 words), 1.78 resident at [8, 1024] (8,192 words)
RESIDENT_MAX_WORDS = 2048
TILED_GENS = 16              # form (b): generations per launch


class B4Plan(NamedTuple):
    form: str      # "resident" (a) or "tiled" (b)
    launches: int  # grid launches of the call


def _b4_plan(wn: int, cn: int, k: int, form: str | None = None) -> B4Plan:
    """B4's form and launches for k generations of a packed [wn, cn] grid.

    form (a), "resident": the whole grid in the registers of one block for
    all k generations, one launch; it can hold at most RESIDENT_MAX_ROWS
    word rows and RESIDENT_MAX_THREADS columns in whole warps, and is
    taken up to RESIDENT_MAX_WORDS words. form (b), "tiled":
    ceil(k / TILED_GENS) launches on halo'd tiles, any size. `form` forces
    one (a grid form (a) cannot hold raises). k = 0 launches nothing."""
    fits = (1 <= wn <= RESIDENT_MAX_ROWS and 0 < cn <= RESIDENT_MAX_THREADS
            and cn % BITS == 0)
    if form is None:
        form = ("resident" if fits and wn * cn <= RESIDENT_MAX_WORDS
                else "tiled")
    if form == "resident":
        if not fits:
            raise ValueError(f"B4's resident form cannot hold a packed "
                             f"[{wn}, {cn}] grid")
        return B4Plan("resident", int(k > 0))
    if form != "tiled":
        raise ValueError(f"B4 has no form {form!r}")
    return B4Plan("tiled", -(-k // TILED_GENS))


@functools.cache
def _b4_kernel():
    lib = load_kernel_lib("gol_swar")
    fn = lib.lib.gs_swar
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib, fn


def multi_step_packed_cuda(packed: torch.Tensor, k: int,
                           form: str | None = None) -> torch.Tensor:
    """Launch kernel B4 (csrc/gol_swar.cu): k generations of a contiguous
    packed [W, C] CUDA grid -> new int32 words, the input unchanged.

    ``_b4_plan`` picks the form (``form`` forces one) and the launches:
    one for the resident form, ceil(k / 16) tiled;
    ``multi_step_packed_cuda.launches`` counts those grid launches.
    """
    p = _words(packed)
    if p.device.type != "cuda":
        raise ValueError(f"kernel B4 runs on CUDA tensors, got {p.device}")
    if p.dim() != 2 or not p.is_contiguous():
        raise ValueError(f"kernel B4 needs a contiguous 2-D packed grid, "
                         f"got {tuple(p.shape)}")
    k = int(k)
    if k < 0:
        raise ValueError(f"k = {k} < 0")
    wn, cn = p.shape
    plan = _b4_plan(wn, cn, k, form)
    if k == 0:
        return p.clone()
    lib, fn = _b4_kernel()
    out = torch.empty_like(p)
    scratch = torch.empty_like(p) if plan.launches > 1 else out
    launched = ctypes.c_int(0)
    rc = fn(ptr(p), ptr(out), ptr(scratch), wn, cn, k,
            int(plan.form == "resident"), stream_ptr(p.device),
            ctypes.byref(launched))
    multi_step_packed_cuda.launches += launched.value
    lib.check(rc, "kernel B4 (gs_swar)")
    return out


multi_step_packed_cuda.launches = 0


def multi_step_packed(packed: torch.Tensor, k: int) -> torch.Tensor:
    """k generations on a packed [W, C] grid -> uint32 [W, C]. CUDA
    tensors launch kernel B4, CPU tensors take its plain version."""
    dev = packed.device
    if dev.type == "cuda":
        out = multi_step_packed_cuda(packed.contiguous(), k)
    elif dev.type == "cpu":
        out = multi_step_packed_plain(packed, k)
    else:
        raise ValueError(f"no SWAR GoL for device {dev}")
    return out.view(torch.uint32)


def multi_step_swar(grid: torch.Tensor, k: int) -> torch.Tensor:
    """Drop-in multi_step: [R, C] cell grid -> k generations -> the same
    shape and dtype. Packs rows to bits, runs multi_step_packed, unpacks.
    Rows must be a multiple of 32; unlike the JAX kernel there is no
    ceiling on the cell count."""
    r, c = grid.shape
    if r % BITS:
        raise ValueError(f"{r}x{c} grid not supported by the SWAR kernel "
                         f"(rows % {BITS} == 0); use gol_stencil.multi_step")
    out = multi_step_packed(pack_rows(grid), k)
    return unpack_rows(out, dtype=grid.dtype)


# The JAX package routes grids past its VMEM ceiling through a banded
# chain here; B4 tiles any 32-row-aligned size itself, so "auto" is the
# one kernel.
multi_step_swar_auto = multi_step_swar

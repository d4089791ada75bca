"""Block Barnes-Hut: the approximate N-body step, as plain torch ops.

Port of rustexp_tpu/ops/nbody_bh.py (the reference's Barnes-Hut quadtree,
nbody.rs:186-480, on a flat structure):

  1. sort the particles by Morton (Z-order) code, so equal-count blocks of
     the sorted array are spatial cells (kernel B6 at power-of-two N);
  2. per block, the centre of mass and the AABB;
  3. near field (exact): for each target block, the K(theta) source blocks
     with the smallest AABB distance over source diagonal (the s/d < theta
     opening test, blockwise; the block itself always first) get exact
     pair forces;
  4. far field: every other block contributes its monopole.

K(theta) = ceil(19 / theta^2), cross-calibrated in the JAX package
against the reference quadtree (its module docstring). The JAX package
wrote steps 2-4 as XLA ops outside any Pallas kernel; here they are torch
ops, but for the two force fields on the card: CUDA tensors launch the
hand-written kernels N (the near field, near_field_cuda) and F (the far
field, far_field_cuda), both in csrc/nbody_forces.cu; CPU tensors take
their plain versions, near_field_plain and far_field_plain. theta == 0 is
the brute-force route (the caller's choice). The step returns the
particles in Morton order.

Spans of step_bh (core/trace.py), every device op of the step in one:
``nbody.sort`` (step 1), ``nbody.blocks`` (step 2 and the near-set
ranking), ``nbody.near`` (the exact pairs of step 3), ``nbody.far`` (step
4, the sum of the two fields and the target mass) and ``nbody.integrate``
(the Euler update and the runaway kill).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.trace import span
from ..runtime import load_kernel_lib, ptr, stream_ptr
from .nbody_forces import EPS, euler, kill_runaway
from .sort_bitonic import sort_kv

# Route power-of-two sorts through kernel B6 (ops/sort_bitonic.py), as the
# JAX package routes them through its Pallas network; both equal the
# stable argsort route bit for bit.
USE_BITONIC_SORT = True


def _morton16(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Interleave two <= 15-bit int32s into a positive int32 Z-order code."""

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(ix) | (spread(iy) << 1)


def morton_codes(px, py, x1, x2, y1, y2, bits: int = 15) -> torch.Tensor:
    """Z-order codes for positions against an explicit bounding box."""
    scale = (1 << bits) - 1
    ix = ((px - x1) / (x2 - x1).clamp(min=1e-12) * scale).clamp(0, scale)
    iy = ((py - y1) / (y2 - y1).clamp(min=1e-12) * scale).clamp(0, scale)
    return _morton16(ix.to(torch.int32), iy.to(torch.int32))


def morton_sort(px, py, m, vx=None, vy=None, bits: int = 15):
    """The particle arrays [px, py, m(, vx, vy)] permuted into Z order.

    With USE_BITONIC_SORT, power-of-two counts >= 256 go through sort_kv
    (kernel B6 on the card, a radix sort that gathers the arrays once by
    its permutation); other counts take a stable argsort and gathers.
    Both give the same arrays bit for bit.
    """
    code = morton_codes(px, py, px.min(), px.max(), py.min(), py.max(), bits)
    vals = [px, py, m] + ([vx, vy] if vx is not None else [])
    n = px.shape[0]
    if USE_BITONIC_SORT and n >= 256 and n & (n - 1) == 0:
        return sort_kv(code, vals)[1]
    order = torch.argsort(code, stable=True)
    return [v[order] for v in vals]


def theta_to_k(theta: float, n_blocks: int) -> int:
    """Exact near-field blocks for theta: ~1/theta^2, 0.85 -> 27."""
    if theta <= 0:
        raise ValueError("theta == 0 is the brute-force route")
    return max(2, min(n_blocks, int(-(-19.0 // (theta * theta)))))


def near_block_indices(x1, x2, y1, y2, k_near: int, row0=None,
                       rows: int | None = None) -> torch.Tensor:
    """int64 [rows, k_near]: per target block, the k_near source blocks
    ranked first by squared AABB distance over the source block's squared
    diagonal, the block itself pinned first (ratio -1), ties to the lower
    index (stable argsort). `row0`/`rows` compute only the target rows
    row0 .. row0 + rows - 1, equal to those rows of the full table."""
    if rows is None:
        r0, rows = 0, x1.shape[0]
    else:
        r0 = int(row0)
    tx1, tx2 = x1[r0:r0 + rows], x2[r0:r0 + rows]
    ty1, ty2 = y1[r0:r0 + rows], y2[r0:r0 + rows]
    ddx = torch.maximum(x1[None, :] - tx2[:, None],
                        tx1[:, None] - x2[None, :]).clamp(min=0.0)
    ddy = torch.maximum(y1[None, :] - ty2[:, None],
                        ty1[:, None] - y2[None, :]).clamp(min=0.0)
    d2 = ddx * ddx + ddy * ddy
    wx, wy = x2 - x1, y2 - y1
    ratio = d2 / (wx * wx + wy * wy).clamp(min=1e-12)[None, :]
    rr = torch.arange(rows, device=x1.device)
    ratio[rr, r0 + rr] = -1.0
    return torch.argsort(ratio, dim=1, stable=True)[:, :k_near]


def block_aggregates(xb, yb, mb):
    """(msum, cx, cy) of [B, block] blocks: each block's mass and centre
    of mass (the mass floored at 1e-30 before its reciprocal)."""
    msum = mb.sum(dim=1)
    inv = torch.reciprocal(msum.clamp(min=1e-30))
    return msum, (xb * mb).sum(dim=1) * inv, (yb * mb).sum(dim=1) * inv


def near_field_plain(xt, yt, xb, yb, mb, idx):
    """Plain PyTorch version of kernel N: exact pair forces per unit
    target mass on target blocks xt, yt [nt, block] from the source blocks
    idx [nt, K] names among xb, yb, mb [B, block] -> (fx, fy) [nt, block],
    one gathered source block at a time; the self pairs of the diagonal
    block add exactly zero (d = 0)."""
    fx = torch.zeros_like(xt)
    fy = torch.zeros_like(yt)
    for k in range(idx.shape[1]):
        src = idx[:, k]
        dx = xb[src][:, None, :] - xt[:, :, None]            # [nt, tgt, src]
        dy = yb[src][:, None, :] - yt[:, :, None]
        r = mb[src][:, None, :] / (dx * dx + dy * dy + EPS)
        fx = fx + (r * dx).sum(dim=2)
        fy = fy + (r * dy).sum(dim=2)
    return fx, fy


NEAR_MAX_BLOCK = 256  # the kernel's largest block (csrc/nbody_forces.cu)


@functools.cache
def _near_kernel():
    lib = load_kernel_lib("nbody_forces")
    fn = lib.lib.nb_near_field
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib, fn


def near_field_cuda(xt, yt, xb, yb, mb, idx):
    """Launch kernel N (csrc/nbody_forces.cu) -> (fx, fy) [nt, block], the
    near field of near_field_plain, for contiguous f32 xt, yt [nt, block]
    and xb, yb, mb [nb, block] CUDA tensors and int64 idx [nt, K], K <= nb,
    whose rows may be strided (as ``argsort(...)[:, :K]`` gives them) but
    whose entries are not. idx's values are not read on the host, which
    would wait for the card: the kernel gives NaN forces to a target block
    whose row names a block outside [0, nb).

    ``near_field_cuda.launches`` counts the grid launches: 1 a call (none
    for nt = 0).
    """
    f32 = {"xt": xt, "yt": yt, "xb": xb, "yb": yb, "mb": mb}
    every = (*f32.items(), ("idx", idx))
    for name, t in every:
        dtype = torch.int64 if name == "idx" else torch.float32
        if t.dtype != dtype or t.dim() != 2:
            raise ValueError(f"{name}: need a 2-D {dtype} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    nt, block = xt.shape
    nb, k = xb.shape[0], idx.shape[1]
    for name, t, shape in (("yt", yt, (nt, block)), ("xb", xb, (nb, block)),
                           ("yb", yb, (nb, block)), ("mb", mb, (nb, block)),
                           ("idx", idx, (nt, k))):
        if t.shape != shape:
            raise ValueError(f"{name}: need shape {shape} beside xt "
                             f"{tuple(xt.shape)}, got {tuple(t.shape)}")
    if not 1 <= block <= NEAR_MAX_BLOCK or not 1 <= k <= nb:
        raise ValueError(f"block {block}, K {k}, {nb} source blocks: need "
                         f"1 <= block <= {NEAR_MAX_BLOCK} and 1 <= K <= "
                         f"{nb}")
    for name, t in f32.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
    if (k > 1 and idx.stride(1) != 1) or (nt > 1 and idx.stride(0) < k):
        raise ValueError(f"idx: need unit-stride rows, got strides "
                         f"{idx.stride()}")
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError(f"kernel N runs on CUDA tensors, got {dev}")
    for name, t in every:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xt on {dev}")
    lib, fn = _near_kernel()
    fx = torch.empty_like(xt)
    fy = torch.empty_like(yt)
    launched = ctypes.c_int(0)
    rc = fn(ptr(xt), ptr(yt), ptr(xb), ptr(yb), ptr(mb), ptr(idx), ptr(fx),
            ptr(fy), nt, nb, block, k, idx.stride(0) if nt > 1 else k,
            stream_ptr(dev), ctypes.byref(launched))
    near_field_cuda.launches += launched.value
    lib.check(rc, "kernel N (nb_near_field)")
    return fx, fy


near_field_cuda.launches = 0


def near_field(xt, yt, xb, yb, mb, idx):
    """Exact pair forces per unit target mass on target blocks xt, yt
    [nt, block] from the source blocks idx [nt, K] names among xb, yb, mb
    [B, block] -> (fx, fy) [nt, block]. CUDA tensors launch kernel N,
    CPU tensors take its plain version."""
    dev = xt.device
    if dev.type == "cuda":
        return near_field_cuda(xt, yt, xb, yb, mb, idx)
    if dev.type == "cpu":
        return near_field_plain(xt, yt, xb, yb, mb, idx)
    raise ValueError(f"no near field for device {dev}")


def far_field_plain(xt, yt, msum, cx, cy, idx):
    """Plain PyTorch version of kernel F: forces per unit target mass on
    target blocks xt, yt [nt, block] from the monopoles (msum, cx, cy) [B]
    of every block outside each target block's near set idx [nt, K] ->
    (gx, gy) [nt * block], over [nt * block, B] temporaries."""
    nt, block = xt.shape
    near = torch.zeros((nt, msum.shape[0]), dtype=torch.bool,
                       device=xt.device)
    near[torch.arange(nt, device=xt.device)[:, None], idx] = True
    pxt, pyt = xt.reshape(-1), yt.reshape(-1)
    dxf = cx[None, :] - pxt[:, None]                                # [n, B]
    dyf = cy[None, :] - pyt[:, None]
    rf = msum[None, :] / (dxf * dxf + dyf * dyf + EPS)
    rf = torch.where(near.repeat_interleave(block, dim=0), 0.0, rf)
    return (rf * dxf).sum(dim=1), (rf * dyf).sum(dim=1)


FAR_MAX_BLOCK = 256  # the kernel's largest block (csrc/nbody_forces.cu)


@functools.cache
def _far_kernel():
    lib = load_kernel_lib("nbody_forces")
    fn = lib.lib.nb_far_field
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib, fn


def far_field_cuda(xt, yt, msum, cx, cy, idx):
    """Launch kernel F (csrc/nbody_forces.cu) -> (gx, gy) [nt * block],
    the far field of far_field_plain, for contiguous f32 xt, yt [nt,
    block], f32 msum, cx, cy [nb] (strided vectors too) and int64 idx [nt,
    K], K <= nb, CUDA tensors; idx's rows may be strided (as
    ``argsort(...)[:, :K]`` gives them) but its entries not. idx's values
    are not read on the host, which would wait for the card: the kernel
    gives NaN forces to a target block whose row names a block outside
    [0, nb).

    ``far_field_cuda.launches`` counts the grid launches: 1 a call (none
    for nt = 0).
    """
    every = (("xt", xt, 2), ("yt", yt, 2), ("msum", msum, 1), ("cx", cx, 1),
             ("cy", cy, 1), ("idx", idx, 2))
    for name, t, rank in every:
        dtype = torch.int64 if name == "idx" else torch.float32
        if t.dtype != dtype or t.dim() != rank:
            raise ValueError(f"{name}: need a {rank}-D {dtype} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    nt, block = xt.shape
    nb, k = msum.shape[0], idx.shape[1]
    for name, t, shape in (("yt", yt, (nt, block)), ("cx", cx, (nb,)),
                           ("cy", cy, (nb,)), ("idx", idx, (nt, k))):
        if t.shape != shape:
            raise ValueError(f"{name}: need shape {shape} beside xt "
                             f"{tuple(xt.shape)} and msum ({nb},), got "
                             f"{tuple(t.shape)}")
    if not 1 <= block <= FAR_MAX_BLOCK or not 1 <= k <= nb:
        raise ValueError(f"block {block}, K {k}, {nb} monopoles: need "
                         f"1 <= block <= {FAR_MAX_BLOCK} and 1 <= K <= {nb}")
    for name, t in (("xt", xt), ("yt", yt)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
    if (k > 1 and idx.stride(1) != 1) or (nt > 1 and idx.stride(0) < k):
        raise ValueError(f"idx: need unit-stride rows, got strides "
                         f"{idx.stride()}")
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError(f"kernel F runs on CUDA tensors, got {dev}")
    for name, t, _ in every:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xt on {dev}")
    lib, fn = _far_kernel()
    gx = torch.empty(nt * block, dtype=torch.float32, device=dev)
    gy = torch.empty_like(gx)
    launched = ctypes.c_int(0)
    rc = fn(ptr(xt), ptr(yt), ptr(msum), ptr(cx), ptr(cy), msum.stride(0),
            cx.stride(0), cy.stride(0), ptr(idx), ptr(gx), ptr(gy), nt, nb,
            block, k, idx.stride(0) if nt > 1 else k, stream_ptr(dev),
            ctypes.byref(launched))
    far_field_cuda.launches += launched.value
    lib.check(rc, "kernel F (nb_far_field)")
    return gx, gy


far_field_cuda.launches = 0


def far_field(xt, yt, msum, cx, cy, idx):
    """Forces per unit target mass on target blocks xt, yt [nt, block]
    from the monopoles (msum, cx, cy) [B] of every block outside each
    target block's near set idx [nt, K] -> (gx, gy) [nt * block]. CUDA
    tensors launch kernel F, CPU tensors take its plain version."""
    dev = xt.device
    if dev.type == "cuda":
        return far_field_cuda(xt, yt, msum, cx, cy, idx)
    if dev.type == "cpu":
        return far_field_plain(xt, yt, msum, cx, cy, idx)
    raise ValueError(f"no far field for device {dev}")


def forces_on_blocks(xt, yt, xb, yb, mb, msum, cx, cy, idx):
    """Forces per unit target mass on target blocks xt, yt [nt, block]
    from the sources xb, yb, mb [B, block] -> (fx, fy) [nt * block]:
    exact pairs with the source blocks idx [nt, K] names, the monopoles
    (msum, cx, cy) of every other block. One target block's sums have the
    same shapes whatever nt is, so a slice of the target blocks gets the
    same forces as the whole (the sharded step, parallel/nbody_shard.py)."""
    fx, fy = near_field(xt, yt, xb, yb, mb, idx)
    gx, gy = far_field(xt, yt, msum, cx, cy, idx)
    return fx.reshape(-1) + gx, fy.reshape(-1) + gy


def forces_bh_sorted(px, py, m, block: int, k_near: int):
    """Forces on Morton-sorted particles: the k_near-block exact near field
    plus the block-monopole far field -> (fx, fy), with the target mass:
    forces_on_blocks' two halves on every block, each stage a span."""
    n = px.shape[0]
    nb = n // block
    if n % block or not 1 < k_near <= nb:
        raise ValueError(f"N={n}, block={block}, k_near={k_near}: need "
                         f"block | N and 1 < k_near <= N/block")
    with span("nbody.blocks"):
        xb, yb, mb = (a.reshape(nb, block) for a in (px, py, m))
        msum, cx, cy = block_aggregates(xb, yb, mb)
        idx = near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                 yb.amax(1), k_near)                # [B, K]
    with span("nbody.near"):
        fx, fy = near_field(xb, yb, xb, yb, mb, idx)
    with span("nbody.far"):
        gx, gy = far_field(xb, yb, msum, cx, cy, idx)
        return (fx.reshape(-1) + gx) * m, (fy.reshape(-1) + gy) * m


def step_bh(px, py, vx, vy, m, block: int, k_near: int, dt: float = 0.01):
    """One Euler step: Morton sort, block-BH forces, integrate, runaway
    kill (nbody.rs:460-471, after the position update). Returns
    (px, py, vx, vy, m) in Morton order."""
    with span("nbody.sort"):
        px, py, m, vx, vy = morton_sort(px, py, m, vx, vy)
    fx, fy = forces_bh_sorted(px, py, m, block, k_near)
    with span("nbody.integrate"):
        px, py, vx, vy = euler(px, py, vx, vy, m, fx, fy, dt)
        vx, vy = kill_runaway(px, py, vx, vy)
    return px, py, vx, vy, m

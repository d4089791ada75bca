"""The shading and pack layer: a raster kernel's planes -> the packed frame.

Port of the shade tails of rustexp_tpu/raster/pipeline.py (:501-506,
:422-450 and :661-766): each covered pixel's 1/w, colour, world position
and normal from the raster kernel's attribute planes, the shader of
raster/shaders.py, core.colors' gamma pack, over the background.

shade_pack is the one entry: CUDA tensors launch the kernel of
csrc/raster_shade.cu (shade_pack_cuda, one launch, the eye passed by
value), CPU tensors take the plain chain (shade_pack_plain), which the
kernel repeats op for op. Over the whole frame, or over the blocks a rows
list names (the compacted shade: block_w pixels of one row each, entries
>= h * (w // block_w) padding). inv_world_to_vp, the ray unprojection's
matrix, is the shade's; the matrix helpers it shares with the transform
are in raster/exact.py.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import trace
from ..core.colors import _gamma_curve, pack_abgr32_gamma_arith
from ..runtime import load_kernel_lib, stream_ptr
from . import shaders as sh
from .exact import _cross3_exact, _device_eye, _host_eye, _mm4_exact

MAX_PLANES = 10


@functools.cache
def _inv_projection(w: int, h: int) -> tuple:
    """(inverse perspective, inverse viewport) f32 [4, 4] host tensors:
    the part of inv_world_to_vp that depends on the frame's size alone."""
    # numpy-2 promotion of the JAX package's expressions, spelled out
    f = np.float32
    tan_half = np.tan(f(45.0) * f(0.0174532925) / f(2.0))
    near, far = 0.1, 10.0
    m00 = f(1.0) / (f(w / h) * tan_half)
    m11 = f(1.0) / tan_half
    m22 = -(far + near) / (far - near)
    m23 = -(2.0 * far * near) / (far - near)
    inv_persp = torch.tensor(
        [[f(1.0) / m00, 0, 0, 0], [0, f(1.0) / m11, 0, 0],
         [0, 0, 0, -1.0], [0, 0, 1.0 / m23, m22 / m23]], dtype=torch.float32)
    wh, hh = w / 2.0, h / 2.0
    inv_vpm = torch.tensor(
        [[1.0 / wh, 0, 0, -1.0], [0, 1.0 / hh, 0, -1.0],
         [0, 0, 1.0, 0], [0, 0, 0, 1.0]], dtype=torch.float32)
    return inv_persp, inv_vpm


def inv_world_to_vp(eye, w: int, h: int):
    """Analytic inverse of the world->viewport chain, for ray unprojection
    (rustexp_tpu/raster/pipeline.py:236). Host f32 [4, 4].

    The JAX package composes it with ``@`` and ``jnp.cross``, which
    XLA:CPU may contract into FMAs; here every product rounds on its own
    and the products chain left to right, so CPU and card agree.
    """
    eye = _host_eye(eye)
    zaxis = sh.normalize(eye)
    xaxis = sh.normalize(_cross3_exact(torch.tensor([0.0, 1.0, 0.0]), zaxis))
    yaxis = _cross3_exact(zaxis, xaxis)
    R = torch.stack([xaxis, yaxis, zaxis])  # rows
    inv_look = torch.cat([torch.cat([R.T, eye[:, None]], dim=1),
                          torch.tensor([[0.0, 0.0, 0.0, 1.0]])])
    inv_persp, inv_vpm = _inv_projection(w, h)
    return _mm4_exact(_mm4_exact(inv_look, inv_persp), inv_vpm)


def _blocks(rows, w: int, h: int, block_w: int):
    """(rows_g, padr, comp) of a shade-block list: entries >= h*(w//block_w)
    are padding (padr), rows_g points them at block 0, and comp(plane)
    gathers a [h, w] plane's listed blocks to [Rc, block_w]."""
    n_blk = h * (w // block_w)
    padr = rows >= n_blk
    rows_g = torch.where(padr, 0, rows).long()

    def comp(plane):
        return plane.reshape(n_blk, block_w)[rows_g]

    return rows_g, padr, comp


def _check_planes(lin, per_pixel: bool, ray_world: bool) -> None:
    want = 4 if not per_pixel else (7 if ray_world else 10)
    if len(lin) != want:
        raise ValueError(f"{len(lin)} planes; the shade reads {want} "
                         f"(per_pixel={per_pixel}, ray_world={ray_world})")


def shade_pack_plain(mask, z, lin, bg_fb, cm, eye, tick, *, shader_idx: int,
                     per_pixel: bool, ray_world: bool, rows=None,
                     block_w: int | None = None, compact: bool = False,
                     y0: int = 0, full_h: int | None = None, y_rows=None):
    """Plain PyTorch shade and pack -> int32 [h, w] ABGR bits; shade_pack
    says what the arguments are.

    wr = 1/lin[0] and the colour lin[1:4] * wr; per pixel the world
    position, unprojected from (x, y, z) and wr (ray_world) or lin[4:7] *
    wr, the normal lin[4:7] or lin[7:10] times wr, and the shader; then
    the gamma pack where `mask` is set, the background elsewhere. With a
    rows list the listed blocks are gathered (unless `compact`), shaded
    and scattered back over the background; pads scatter into one extra
    row that is dropped.
    """
    _check_planes(lin, per_pixel, ray_world)
    h, w = bg_fb.shape
    dev = bg_fb.device
    if rows is not None:
        ntx = w // block_w
        n_blk = h * ntx
        rows_g, padr, comp = _blocks(rows, w, h, block_w)
    if rows is None or compact:
        def take(plane):
            return plane
    else:
        take = comp
    maskc = take(mask)
    linc = [take(p_) for p_ in lin]
    wrc = 1.0 / linc[0]
    out = torch.stack([p_ * wrc for p_ in linc[1:4]], dim=-1)
    if per_pixel:
        if ray_world:
            nc = torch.stack([p_ * wrc for p_ in linc[4:7]], dim=-1)
            if rows is None:
                ly = torch.arange(h, device=dev)[:, None]
                xc = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            else:
                ly = torch.div(rows_g, ntx, rounding_mode="floor")[:, None]
                xc = ((rows_g % ntx) * block_w).to(torch.float32)[:, None] \
                    + torch.arange(block_w, dtype=torch.float32,
                                   device=dev)[None, :]
            if y_rows is None:
                yc = (ly + y0).to(torch.float32)
            else:
                yc = trace.upload(
                    "rows", torch.as_tensor(y_rows).to(torch.float32),
                    dev)[ly]
            zc = take(z)
            M = inv_world_to_vp(eye, w, h if full_h is None
                                else full_h).tolist()
            pc = torch.stack(
                [wrc * (M[i][0] * xc + M[i][1] * yc + M[i][2] * zc + M[i][3])
                 for i in range(3)], dim=-1)
        else:
            pc = torch.stack([p_ * wrc for p_ in linc[4:7]], dim=-1)
            nc = torch.stack([p_ * wrc for p_ in linc[7:10]], dim=-1)
        out = sh.shader_fn(shader_idx)(pc, nc, out, _device_eye(eye, dev),
                                       tick, cm)
    packed = pack_abgr32_gamma_arith(out[..., 0], out[..., 1], out[..., 2])
    if rows is None:
        return torch.where(maskc, packed, bg_fb)
    bgv = bg_fb.reshape(n_blk, block_w)
    merged = torch.where(maskc, packed, bgv[rows_g])
    # rows are unique
    buf = torch.cat([bgv, bgv[:1]])
    buf[torch.where(padr, n_blk, rows).long()] = merged
    return buf[:n_blk].reshape(h, w)


class _ShadeArgs(ctypes.Structure):
    """csrc/raster_shade.cu's ShadeArgs, field for field."""

    _fields_ = [("mask", ctypes.c_void_p), ("z", ctypes.c_void_p),
                ("planes", ctypes.c_void_p * MAX_PLANES),
                ("bg", ctypes.c_void_p), ("rows", ctypes.c_void_p),
                ("y_rows", ctypes.c_void_p), ("cm", ctypes.c_void_p),
                ("curve", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("block_w", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("compact", ctypes.c_int), ("y0", ctypes.c_int),
                ("eye", ctypes.c_float * 3),
                ("inv_persp", ctypes.c_float * 16),
                ("inv_vpm", ctypes.c_float * 16)]


@functools.cache
def _kernel():
    """The built kernel library and its C entry, typed once."""
    lib = load_kernel_lib("raster_shade")
    fn = lib.lib.rs_shade_pack
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_ShadeArgs)] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib, fn


@functools.cache
def _projection_floats(w: int, h: int) -> tuple:
    inv_persp, inv_vpm = _inv_projection(w, h)
    return (tuple(inv_persp.reshape(-1).tolist()),
            tuple(inv_vpm.reshape(-1).tolist()))


def _eye_floats(eye) -> list:
    """The eye's three f32 values as Python floats (exact)."""
    if isinstance(eye, torch.Tensor):
        return _host_eye(eye).tolist()
    return np.asarray(eye, np.float32).reshape(3).tolist()


def shade_pack_cuda(mask, z, lin, bg_fb, cm, eye, *, shader_idx: int,
                    per_pixel: bool, ray_world: bool, rows=None,
                    block_w: int | None = None, compact: bool = False,
                    y0: int = 0, full_h: int | None = None, y_rows=None):
    """Launch the shade-and-pack kernel (csrc/raster_shade.cu) -> int32
    [h, w]: shade_pack_plain's frame, bit for bit, in one grid (a rows
    list's background is copied into the frame first). The eye and the
    ray matrix's constants go by value: no host tensor op, no upload
    (y_rows, a band's row map, is uploaded as the plain chain does).

    ``shade_pack_cuda.launches`` counts the grid launches.
    """
    _check_planes(lin, per_pixel, ray_world)
    if not 0 <= shader_idx < sh.NUM_SHADERS:
        raise ValueError(f"shader index {shader_idx} is not one of the "
                         f"{sh.NUM_SHADERS} shaders")
    dev = bg_fb.device
    h, w = bg_fb.shape
    if rows is None:
        shape = (h, w)
    else:
        if block_w is None or block_w <= 0 or w % block_w:
            raise ValueError(f"block_w {block_w} does not divide w {w}")
        shape = (rows.shape[0], block_w) if compact else (h, w)
    want = [("mask", mask, torch.bool, shape), ("bg_fb", bg_fb, torch.int32,
                                                (h, w)),
            ("cm", cm, torch.float32, (5, 6, sh.CM_FACE_WDH,
                                       sh.CM_FACE_WDH, 3))]
    want += [(f"lin[{k}]", p_, torch.float32, shape) for k, p_ in
             enumerate(lin)]
    if per_pixel and ray_world:
        want.append(("z", z, torch.float32, shape))
    if rows is not None:
        want.append(("rows", rows, torch.int32, (rows.shape[0],)))
    for name, t, dt, shp in want:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shp
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shp} tensor "
                             f"on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"the shade kernel runs on CUDA tensors, got {dev}")
    yr = None
    if per_pixel and ray_world and y_rows is not None:
        yr = trace.upload("rows", torch.as_tensor(y_rows).to(torch.int32),
                          dev)
        if yr.shape != (h,):
            raise ValueError(f"y_rows: {h} rows, got {tuple(yr.shape)}")
    lib, fn = _kernel()
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    inv_persp, inv_vpm = _projection_floats(w, h if full_h is None
                                            else full_h)
    planes = [p_.data_ptr() for p_ in lin] + [None] * (MAX_PLANES - len(lin))

    def addr(t):
        return None if t is None else t.data_ptr()

    args = _ShadeArgs(
        mask=mask.data_ptr(), z=addr(z),
        planes=(ctypes.c_void_p * MAX_PLANES)(*planes), bg=bg_fb.data_ptr(),
        rows=addr(rows), y_rows=addr(yr), cm=cm.data_ptr(),
        curve=_gamma_curve(dev).data_ptr(), out=out.data_ptr(), h=h, w=w,
        block_w=block_w or 0,
        n_rows=0 if rows is None else rows.shape[0], compact=int(compact),
        y0=y0, eye=(ctypes.c_float * 3)(*_eye_floats(eye)),
        inv_persp=(ctypes.c_float * 16)(*inv_persp),
        inv_vpm=(ctypes.c_float * 16)(*inv_vpm))
    launched = ctypes.c_int(0)
    rc = fn(ctypes.byref(args), shader_idx, int(per_pixel), int(ray_world),
            stream_ptr(dev), ctypes.byref(launched))
    lib.check(rc, "shade kernel (rs_shade_pack)")
    shade_pack_cuda.launches += launched.value
    return out


shade_pack_cuda.launches = 0


def shade_pack(mask, z, lin, bg_fb, cm, eye, tick, *, shader_idx: int,
               per_pixel: bool, ray_world: bool, rows=None,
               block_w: int | None = None, compact: bool = False,
               y0: int = 0, full_h: int | None = None, y_rows=None):
    """Shade and pack one frame -> int32 [h, w] ABGR bits.

    `mask` (bool), `z` (read per pixel with ray_world) and the planes
    `lin` (4 in V mode: 1/w and RGB/w; per pixel 7 with ray_world, the
    normals added, else 10, world positions then normals) are [h, w], or
    [len(rows), block_w] when `compact`. `bg_fb` is the int32 [h, w]
    background, `cm` the cube-map set. Without `rows` the whole frame is
    shaded; with it (int32, entries >= h * (w // block_w) padding) only
    the listed blocks, the rest is the background. A band of a taller
    frame unprojects its rays at global rows: local row y is y0 + y of a
    full_h-row frame, or y_rows[y]. CUDA tensors launch the kernel, CPU
    tensors take the plain chain.
    """
    kw = dict(shader_idx=shader_idx, per_pixel=per_pixel,
              ray_world=ray_world, rows=rows, block_w=block_w,
              compact=compact, y0=y0, full_h=full_h, y_rows=y_rows)
    dev = bg_fb.device
    if dev.type == "cuda":
        return shade_pack_cuda(mask, z, lin, bg_fb, cm, eye, **kw)
    if dev.type == "cpu":
        return shade_pack_plain(mask, z, lin, bg_fb, cm, eye, tick, **kw)
    raise ValueError(f"no shade path for device {dev}")

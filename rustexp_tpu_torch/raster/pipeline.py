"""The frame pipeline: vertex transform -> raster -> deferred shade -> pack.

Port of rustexp_tpu/raster/pipeline.py for the Fill frame, with its
three raster structures (raster/structure.py routes a frame to one and
builds it; render_frame dispatches on its kind):

* the flat queue (the benchmark's path for meshes of >= 1,000
  triangles): transform_corners_planar (fixed-order per-op f32 matrix
  products on corner-major [3, 4, T] planes, reference
  rasterizer.rs:1181-1231) -> setup_triangles_planar -> the channels
  (on the card all three are kernel T, one launch) -> build_queue
  (cached across frames by the callers, or built every frame by the
  moving camera) -> raster_attrs_queue (kernel B1 on the card) ->
  _shade_compacted over the queue's shade blocks; or, with defer=True,
  raster_zslot_queue (kernel B7, the depth race alone) ->
  _shade_deferred, which re-evaluates each pixel's winning pair;
* the bins (smaller meshes): transform_vertices -> setup_triangles ->
  bin_triangles/bin_pairs -> raster_attrs_bins (kernel B2 on the card)
  -> a full-frame shade, or _shade_compacted over the occupied blocks
  when the bins carry a rows_cap;
* the G-buffer oracle (any frame size): setup_triangles ->
  raster_gbuffer_xla (plain torch) -> shade_gbuffer. The band renderer
  (parallel/raster_shard.py) shades the same G-buffer from kernel B3
  (raster_gbuffer_pallas).

All end in core.colors.pack_abgr32_gamma_arith; the queue and bins paths
shade and pack through raster/shade.py's shade_pack (one kernel launch on
the card, the plain chain on the CPU). The 4x4 camera matrices
are computed on the host in float32 torch (one rounding per op, as the
reference does) and copied to the frame's device, so a frame is
bit-identical on the CPU and on the card. Point and line modes
(draw_points, draw_lines) draw white dots or DDA wireframes over the
background with no raster kernel and no shader.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import trace
from ..core.colors import pack_abgr32, pack_abgr32_gamma_arith, trunc_i32
from ..ops import raster_bins as rb
from ..ops.ieee import lerp_2mad, lerp_3w
from ..ops.raster_queue import (_F_CH, _I_CH, SHADE_W, _eval_pairs,
                                queue_setup_cuda, raster_attrs_queue,
                                raster_zslot_queue)
from ..ops.raster_setup import setup_triangles, setup_triangles_planar
from ..ops.raster_xla import raster_gbuffer_xla
from . import shaders as sh
from . import structure as rs
from .exact import _device_eye, _host_eye, _mm4_exact
from .shade import _blocks, shade_pack

MODE_POINT, MODE_LINE, MODE_FILL = 0, 1, 2
MODE_NAMES = ("Point", "Line", "Fill")

# Vertical-gradient backgrounds (start, end), rasterizer.rs:1287-1294
BACKGROUNDS = (
    ((0.3, 0.3, 0.3), (0.7, 0.7, 0.7)),
    ((1.0, 0.4, 0.0), (0.0, 0.5, 0.5)),
    ((1.0, 0.0, 1.0), (1.0, 0.0, 1.0)),
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
)
NUM_BACKGROUNDS = len(BACKGROUNDS)


class Scene(NamedTuple):
    """Device-resident scene inputs (rustexp_tpu/raster/pipeline.py:49).

    cp3/cn3/cc3 are the corner-major planar corner forms [3, k, T] the
    queue path reads (the JAX Scene's [3T, 3] c_* forms serve its other
    backends). ``cross`` holds the uint32 ABGR preview's bits as int32.
    """

    positions: torch.Tensor  # f32 [V, 3] mesh-space
    normals: torch.Tensor    # f32 [V, 3]
    colors: torch.Tensor     # f32 [V, 3]
    tris: torch.Tensor       # i32 [T, 3]
    ndim: torch.Tensor       # f32 [4, 4] mesh -> unit cube (world)
    it33: torch.Tensor       # f32 [3, 3] inverse-transpose of ndim's 3x3
    cm: torch.Tensor         # f32 [5, 6, 64, 64, 3] irradiance cubemap set
    cross: torch.Tensor      # i32 [ch, cw] unfolded cubemap preview (ABGR bits)
    cp3: torch.Tensor        # f32 [3, 4, T] homogeneous corner positions
    cn3: torch.Tensor        # f32 [3, 3, T] corner normals
    cc3: torch.Tensor        # f32 [3, 3, T] corner baked colors


def make_scene(mesh, cm_set, device: torch.device) -> Scene:
    """Scene from an assets.mesh.MeshData + a CubeMapSet
    (rustexp_tpu/raster/pipeline.py:74), on `device`."""
    ndim = mesh.normalize_dimensions()
    it33 = np.linalg.inv(ndim).T[:3, :3].astype(np.float32)
    tris = np.asarray(mesh.tris)
    pos = np.asarray(mesh.positions)
    nrm = np.asarray(mesh.normals)
    col = np.asarray(mesh.colors)
    posh = np.concatenate([pos, np.ones((pos.shape[0], 1), np.float32)],
                          axis=1)

    # Set-up, not a frame's work, so no sync.* span: the first of these
    # copies starts the CUDA context.
    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return Scene(
        positions=t(pos), normals=t(nrm), colors=t(col),
        tris=t(tris, np.int32), ndim=t(ndim), it33=t(it33),
        cm=t(cm_set.data), cross=t(cm_set.cross.view(np.int32), np.int32),
        cp3=t(posh[tris].transpose(1, 2, 0)),
        cn3=t(nrm[tris].transpose(1, 2, 0)),
        cc3=t(col[tris].transpose(1, 2, 0)),
    )


# ---------------------------------------------------------------------------
# Transform matrices (camera conventions from rasterizer.rs:1236-1259).
# Fixed left-to-right accumulation, one rounding per op (ops/ieee.py).
# ---------------------------------------------------------------------------


def _dot3_exact(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _mv4_exact(m4, v):
    """Fixed-order [4,4] x [4,T] -> [4,T]."""
    s = m4[:, 0:1] * v[0:1]
    s = s + m4[:, 1:2] * v[1:2]
    s = s + m4[:, 2:3] * v[2:3]
    return s + m4[:, 3:4] * v[3:4]


def _mv3_exact(m3, v):
    """Fixed-order [3,3] x [3,T] -> [3,T]."""
    s = m3[:, 0:1] * v[0:1]
    s = s + m3[:, 1:2] * v[1:2]
    return s + m3[:, 2:3] * v[2:3]


def _cross3_f32(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], np.float32)


def _sqrt_f32(x) -> np.float32:
    """torch's float32 square root of a scalar, which this matrix has
    always taken. On a CPU with AVX-512 it is an ulp from the correctly
    rounded root (numpy's) for about 0.6% of arguments: with numpy's, the
    512x512 matrix at the eye (17.893833, -158.7625, 2.8180068) changes
    bits (tests/test_torch_queue_setup.py, test_host_matrix_keeps_its_bits,
    finds 9 such eyes of its 900 drawn)."""
    return torch.sqrt(torch.tensor(x, dtype=torch.float32)).numpy()


def look_at(eye, at, up) -> np.ndarray:
    """Reference look_at (rasterizer.rs:1236-1245) -> f32 [4, 4]:
    division-form normalize, left-to-right dots, translation column
    dot(-eye, axis). numpy float32 rounds each op once, as the
    reference's scalar code does, at a fraction of torch's per-op cost."""
    eye, at, up = (np.asarray(v, np.float32).reshape(3)
                   for v in (eye, at, up))
    za = eye - at
    za = za / _sqrt_f32(_dot3_exact(za, za))
    xa = _cross3_f32(up, za)
    xa = xa / _sqrt_f32(_dot3_exact(xa, xa))
    ya = _cross3_f32(za, xa)
    ne = -eye
    return np.array([[xa[0], xa[1], xa[2], _dot3_exact(ne, xa)],
                     [ya[0], ya[1], ya[2], _dot3_exact(ne, ya)],
                     [za[0], za[1], za[2], _dot3_exact(ne, za)],
                     [0.0, 0.0, 0.0, 1.0]], np.float32)


try:
    _libm = ctypes.CDLL("libm.so.6")
    _libm.tanf.restype = ctypes.c_float
    _libm.tanf.argtypes = [ctypes.c_float]

    def _tanf(x) -> np.float32:
        return np.float32(_libm.tanf(float(np.float32(x))))
except OSError:  # non-glibc host
    def _tanf(x) -> np.float32:
        return np.tan(np.float32(x))


def perspective(fovy_deg: float, aspect: float, near: float, far: float):
    """Per-op f32 like the reference (rasterizer.rs:1247-1258): tanf of the
    f32 degree product; every divide rounds f32."""
    f = np.float32
    tan_half = _tanf(f(fovy_deg) * f(0.0174532925) / f(2.0))
    m00 = f(1.0) / (f(aspect) * tan_half)
    m11 = f(1.0) / tan_half
    m22 = -(f(far) + f(near)) / (f(far) - f(near))
    m23 = -(f(2.0) * f(far) * f(near)) / (f(far) - f(near))
    return torch.tensor(
        [[m00, 0, 0, 0], [0, m11, 0, 0], [0, 0, m22, m23], [0, 0, -1.0, 0]],
        dtype=torch.float32)


def viewport_matrix(w: int, h: int):
    wh, hh = w / 2.0, h / 2.0
    return torch.tensor(
        [[wh, 0, 0, wh], [0, hh, 0, hh], [0, 0, 1, 0], [0, 0, 0, 1]],
        dtype=torch.float32)


@functools.cache
def _projection(w: int, h: int) -> np.ndarray:
    """viewport @ perspective (f32 [4, 4]), the part of the matrix the eye
    leaves alone."""
    return _mm4_exact(viewport_matrix(w, h),
                      perspective(45.0, w / h, 0.1, 10.0)).numpy()


def _world_to_vp_exact(eye, w: int, h: int) -> torch.Tensor:
    """(viewport @ perspective) @ look_at in the oracle's m4_mul order, a
    host f32 [4, 4] tensor."""
    return torch.from_numpy(_mm4_exact(_projection(w, h), look_at(
        eye, np.zeros(3), np.array([0.0, 1.0, 0.0]))))


def _transform_points(scene: Scene, positions, normals, eye, w: int,
                      h: int):
    """(vp with 1/w, world positions, world normals) of [P, 3] mesh-space
    points and normals: transform_vertices' arithmetic on any rows."""
    m = trace.upload("matrix", _world_to_vp_exact(_host_eye(eye), w, h),
                     positions.device)
    pos_h = torch.cat([positions, positions.new_ones((positions.shape[0], 1))],
                      dim=1)
    world_h = _mv4_exact(scene.ndim, pos_h.T).T
    clip = _mv4_exact(m, world_h.T).T
    inv_w = 1.0 / clip[:, 3]
    vp = torch.cat([clip[:, :3] * inv_w[:, None], inv_w[:, None]], dim=1)
    n_world = _mv3_exact(scene.it33, normals.T).T
    return vp, world_h[:, :3], n_world


def transform_vertices(scene: Scene, eye, w: int, h: int):
    """Mesh space -> (viewport vp with 1/w, world positions, world normals)
    per vertex (rustexp_tpu/raster/pipeline.py:270), including the
    reference's viewport-before-divide quirk."""
    return _transform_points(scene, scene.positions, scene.normals, eye, w, h)


def transform_corners(scene: Scene, eye, w: int, h: int):
    """De-indexed corner transform -> (vp_c f32 [3T, 4], n_c f32 [3T, 3]),
    corner j of triangle t at row 3t + j (rustexp_tpu/raster/pipeline.py:326).
    The JAX Scene carries the de-indexed corners; here they are gathered
    from the vertices, and each row's arithmetic is transform_vertices',
    so the result equals vp[tris.reshape(-1)] bit for bit."""
    flat = scene.tris.reshape(-1).long()
    vp_c, _, n_c = _transform_points(scene, scene.positions[flat],
                                     scene.normals[flat], eye, w, h)
    return vp_c, n_c


def transform_corners_planar(scene: Scene, eye, w: int, h: int):
    """Corner-major planar transform (rustexp_tpu/raster/pipeline.py:300).

    Returns (xs, ys, zs, iw, n, world): f32 [3, T] viewport coordinates
    per corner and [3, 3, T] world normals / positions.
    """
    m = trace.upload("matrix", _world_to_vp_exact(_host_eye(eye), w, h),
                     scene.cp3.device)
    world = torch.stack([_mv4_exact(scene.ndim, scene.cp3[j])
                         for j in range(3)])                     # [3, 4, T]
    clip = torch.stack([_mv4_exact(m, world[j]) for j in range(3)])
    iw = 1.0 / clip[:, 3]
    n = torch.stack([_mv3_exact(scene.it33, scene.cn3[j]) for j in range(3)])
    return (clip[:, 0] * iw, clip[:, 1] * iw, clip[:, 2] * iw, iw, n,
            world[:, :3])


# ---------------------------------------------------------------------------
# Flat-queue Fill path
# ---------------------------------------------------------------------------


def vertex_colors(scene: Scene, eye, tick, w: int, h: int, shader_idx: int):
    """Per-vertex shaded colors f32 [V, 3] for V mode: the shader runs on
    the world-space vertices, the raster only interpolates its output."""
    _, world, n_world = transform_vertices(scene, eye, w, h)
    return sh.shader_fn(shader_idx)(world, n_world, scene.colors,
                                    _device_eye(eye, world.device), tick,
                                    scene.cm)


def queue_setup_card(scene: Scene, eye, w: int, h: int, *,
                     band_h: int | None = None, y_shift: int = 0,
                     n3: int | None = None, colors=None):
    """Kernel T's setup of one frame on the card (ops/raster_queue.py
    queue_setup_cuda; with n3, its channel table too): the world-to-
    viewport matrix is computed on the host and goes by value."""
    m = _world_to_vp_exact(_host_eye(eye), w, h)
    return queue_setup_cuda(scene.cp3, scene.cn3, scene.cc3, scene.ndim,
                            scene.it33, m, w, h if band_h is None else band_h,
                            y_shift, n3=n3, colors=colors, tris=scene.tris)


def queue_attr_channels(scene: Scene, colors, eye, w: int, h: int, *,
                        per_pixel: bool, ray_world: bool = True,
                        band_h: int | None = None, y_shift: int = 0):
    """Triangle setup and the kernel's attribute channels for one frame
    -> (setup, extra, n2, n3) (rustexp_tpu/raster/pipeline.py:535-570).

    `colors` is the per-vertex shaded colors in V mode, None in per-pixel
    mode (the baked corner colors are static). The n2 = 4 two-MAD planes
    are 1/w and RGB/w; per-pixel adds three-weight planes: with ray_world
    n3 = 3 normal planes (world positions are unprojected from the pixel),
    without it n3 = 6, world position then normal, interpolated like the
    reference. `band_h`/`y_shift` set up the band_h rows from global row
    y_shift of the w x h frame, translated after the snap (the band
    renderer, parallel/raster_shard.py); the planes do not move. The span
    raster.setup holds it all, raster.transform the transform.

    On the card kernel T computes it all in one launch (raster.transform
    holds that call), and the setup carries the channel table it wrote
    (``setup.table``, whose attribute columns `extra` is); CPU tensors
    take queue_attr_channels_plain.
    """
    kw = dict(band_h=band_h, y_shift=y_shift)
    with trace.span("raster.setup"):
        if scene.cp3.device.type != "cuda":
            return queue_attr_channels_plain(
                scene, colors, eye, w, h, per_pixel=per_pixel,
                ray_world=ray_world, **kw)
        n3 = (3 if ray_world else 6) if per_pixel else 0
        with trace.span("raster.transform"):
            setup = queue_setup_card(
                scene, eye, w, h, n3=n3,
                colors=None if per_pixel else colors.contiguous(), **kw)
        return (setup, list(setup.table[:-1, _I_CH + _F_CH:].unbind(1)), 4,
                n3)


def queue_attr_channels_plain(scene: Scene, colors, eye, w: int, h: int, *,
                              per_pixel: bool, ray_world: bool = True,
                              band_h: int | None = None, y_shift: int = 0):
    """queue_attr_channels' plain chain, on any device: the transform
    (span raster.transform), setup_triangles_planar and the planar
    channels, in eager ops that kernel T repeats op for op."""
    with trace.span("raster.transform"):
        xs, ys, zs, iw, n_c, world_c = transform_corners_planar(
            scene, eye, w, h)
    setup = setup_triangles_planar(
        xs, ys, zs, w, h if band_h is None else band_h, y_shift)
    one = torch.ones_like(iw[0])

    if per_pixel:
        crows = [scene.cc3[0], scene.cc3[1], scene.cc3[2]]  # [3, T]
    else:
        crows = [colors[scene.tris[:, j]].T for j in range(3)]

    def base_d(j):
        return [one, crows[j][0], crows[j][1], crows[j][2]]

    # attr_channels_2mad in planar form: (base, d10, d20) per channel,
    # every product rounded before the subtraction
    # (oracle.cpp:1242-1243)
    base = [q * iw[0] for q in base_d(0)]
    d10 = [q * iw[1] - b for q, b in zip(base_d(1), base)]
    d20 = [q * iw[2] - b for q, b in zip(base_d(2), base)]
    extra = base + d10 + d20
    n2, n3 = 4, 0
    if per_pixel:
        # attr_channels_3w planar: (q*iw0, q*iw1, q*iw2) triples
        cat3 = [([] if ray_world
                 else [world_c[j, k] for k in range(3)])
                + [n_c[j, k] for k in range(3)] for j in range(3)]
        n3 = len(cat3[0])
        extra = extra + [q * iw[j] for j in range(3) for q in cat3[j]]
    return setup, extra, n2, n3


def raster_and_shade_queue(scene: Scene, queue, colors, eye, tick, *,
                           w: int, h: int, per_pixel: bool, shader_idx: int,
                           bg_fb, ray_world: bool = True,
                           defer: bool = False):
    """Flat-queue Fill path (rustexp_tpu/raster/pipeline.py:501). Returns
    (fb int32 [h, w], stale).

    ray_world (the default) unprojects per-pixel world positions from the
    pixel's (x, y, z) and its interpolated 1/w; ray_world=False
    interpolates them like the reference (three more planes, B1's (4, 6)
    instantiation). defer=True runs kernel B7 (the depth race alone) and
    _shade_deferred, which re-evaluates each pixel's winning pair: the
    same frame as defer=False, bit for bit.
    """
    setup, extra, n2, n3 = queue_attr_channels(scene, colors, eye, w, h,
                                               per_pixel=per_pixel,
                                               ray_world=ray_world)
    if defer:
        with trace.span("raster.kernel"):
            z, slot, rows_flat, stale = raster_zslot_queue(queue, setup,
                                                           extra, h, w)
        with trace.span("raster.shade"):
            fb = _shade_deferred(queue, scene, z, slot, rows_flat, n2, n3,
                                 eye, tick, shader_idx, bg_fb, w, h,
                                 per_pixel, ray_world)
        return fb, stale
    with trace.span("raster.kernel"):
        z, mask, lin, stale = raster_attrs_queue(queue, setup, extra, n2, n3,
                                                 h, w)
    with trace.span("raster.shade"):
        if per_pixel:
            fb = _shade_compacted(queue.rows, scene, z, mask, lin, eye, tick,
                                  shader_idx, bg_fb, w, h,
                                  block_w=queue.shade_w, ray_world=ray_world)
        else:
            fb = shade_pack(mask, z, lin, bg_fb, scene.cm, eye, tick,
                            shader_idx=shader_idx, per_pixel=False,
                            ray_world=False)
        return fb, stale


# ---------------------------------------------------------------------------
# Bins Fill path
# ---------------------------------------------------------------------------


def bins_attr_channels(scene: Scene, vp, world, n_world, colors, *,
                       per_pixel: bool):
    """The bins kernel's attribute channels -> (extra f32 [T, 3(n2+n3)],
    n2, n3) (rustexp_tpu/raster/pipeline.py:443-460).

    n2 = 4 two-MAD channels (1/w and RGB/w, from `colors` per vertex:
    shaded in V mode, baked in P mode); per-pixel adds n3 = 6
    three-weight channels, world position and normal, interpolated rather
    than unprojected.
    """
    tris = scene.tris.long()
    i0, i1, i2 = tris[:, 0], tris[:, 1], tris[:, 2]
    iw0, iw1, iw2 = vp[i0, 3], vp[i1, 3], vp[i2, 3]
    ones = vp.new_ones((tris.shape[0], 1))

    def cat2(ci):
        return torch.cat([ones, colors[ci]], dim=1)

    extra = rb.attr_channels_2mad(iw0, iw1, iw2, cat2(i0), cat2(i1), cat2(i2))
    if not per_pixel:
        return extra, 4, 0

    def cat3(ci):
        return torch.cat([world[ci], n_world[ci]], dim=1)

    f3 = rb.attr_channels_3w(iw0, iw1, iw2, cat3(i0), cat3(i1), cat3(i2))
    return torch.cat([extra, f3], dim=1), 4, 6


def _nonzero_static(flags, size: int, fill: int):
    """Indices of the set entries of a 1-D bool tensor, ascending, cut or
    padded with `fill` to `size`: jnp.nonzero(size=, fill_value=) without
    a host read (a cumsum ranks the set entries, a scatter places them)."""
    n = flags.shape[0]
    rank = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    dst = torch.where(flags & (rank < size), rank, size).long()
    out = torch.full((size + 1,), fill, dtype=torch.int32,
                     device=flags.device)
    out.scatter_(0, dst, torch.arange(n, dtype=torch.int32,
                                      device=flags.device))
    return out[:size]  # slot `size` took every unset entry, in no order


def raster_and_shade_pallas(scene: Scene, setup, extra, n2: int, n3: int,
                            eye, tick, *, w: int, h: int, per_pixel: bool,
                            shader_idx: int, bg_fb, cap=None, spans=None,
                            rows_cap=None):
    """Bins Fill path (rustexp_tpu/raster/pipeline.py:422): the attribute
    planes (bins_attr_channels' `extra`, n2, n3) interpolate inside kernel
    B2, then the shade.

    The name is the JAX package's (the bins' backend name is "pallas").
    With per_pixel and ``rows_cap``, the shade runs only on
    the SHADE_W-wide blocks the coverage mask occupies (at most rows_cap
    of them; more raises ``overflow``); otherwise over the whole frame.
    Returns (fb int32 [h, w], overflow): overflow means the static bin
    capacity, spans or rows_cap were exceeded, so re-bin.
    """
    with trace.span("raster.kernel"):
        z, mask, lin, overflow = rb.raster_attrs_bins(setup, extra, n2, n3,
                                                      h, w, cap=cap,
                                                      spans=spans)
    with trace.span("raster.shade"):
        if per_pixel and rows_cap is not None:
            n_blk = h * (w // SHADE_W)
            occ = mask.reshape(n_blk, SHADE_W).any(dim=1)
            rows = _nonzero_static(occ, rows_cap, n_blk)
            overflow = overflow | (occ.sum() > rows_cap)
            fb = _shade_compacted(rows, scene, z, mask, lin, eye, tick,
                                  shader_idx, bg_fb, w, h, ray_world=False)
            return fb, overflow

        fb = shade_pack(mask, z, lin, bg_fb, scene.cm, eye, tick,
                        shader_idx=shader_idx, per_pixel=per_pixel,
                        ray_world=False)
        return fb, overflow


def shade_gbuffer(gb, scene: Scene, vp, world, n_world, colors, eye, tick,
                  *, per_pixel: bool, shader_idx: int, bg_fb):
    """Interpolate each visible pixel's attributes from a G-buffer and
    shade once (rustexp_tpu/raster/pipeline.py:352): the oracle's and the
    band renderer's shade. Returns int32 [h, w] ABGR bits.

    Flat tid -> vertex gathers, then the reference's perspective-correct
    lerps (rasterizer.rs:1695-1744): w_raster = 1 / (2-MAD of 1/w),
    colors by the 2-MAD form of a/w, world positions and normals by the
    three-weight form, each times w_raster, every op rounded once.
    `colors` is per vertex: shaded (V mode) or baked (per-pixel).
    """
    h, w = gb.tid.shape
    mask = gb.tid >= 0
    t = gb.tid.clamp(min=0).reshape(-1).long()
    tris = scene.tris.long()
    i0, i1, i2 = tris[:, 0][t], tris[:, 1][t], tris[:, 2][t]
    b = gb.b.reshape(-1, 3)
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    iw = vp[:, 3:4]
    iw0, iw1, iw2 = iw[i0], iw[i1], iw[i2]                       # [n, 1]
    w_raster = 1.0 / lerp_2mad(iw0, iw1 - iw0, iw2 - iw0, b2, b0)

    def persp_2mad(a):
        base = a[i0] * iw0
        return lerp_2mad(base, a[i1] * iw1 - base, a[i2] * iw2 - base,
                         b2, b0) * w_raster

    def persp_3w(a):
        return lerp_3w(a[i0] * iw0, a[i1] * iw1, a[i2] * iw2,
                       b1, b2, b0) * w_raster

    out = persp_2mad(colors)
    if per_pixel:
        out = sh.shader_fn(shader_idx)(persp_3w(world), persp_3w(n_world),
                                       out, _device_eye(eye, out.device),
                                       tick, scene.cm)
    packed = pack_abgr32_gamma_arith(out[:, 0], out[:, 1], out[:, 2])
    return torch.where(mask, packed.reshape(h, w), bg_fb)


def _shade_compacted(rows, scene: Scene, z, mask, lin, eye, tick,
                     shader_idx: int, bg_fb, w: int, h: int,
                     block_w: int = SHADE_W, ray_world: bool = True,
                     y0: int = 0, full_h: int | None = None, y_rows=None):
    """Deferred per-pixel shading over OCCUPIED shade blocks only
    (rustexp_tpu/raster/pipeline.py:690).

    `rows` (int32 [Rc], entries >= h*(w//block_w) are padding) lists the
    block_w-wide row spans that can hold coverage; the planes are gathered
    to [Rc, block_w], shaded there, and scattered back over the background.
    With ray_world (the queue path's default) world positions are
    unprojected from each pixel's (x, y, z) and its interpolated 1/w;
    without it (the bins path, and the queue path's ray_world=False)
    lin[4:7] and lin[7:10] are the interpolated world positions and
    normals.

    A band of a taller frame (parallel/raster_shard.py) has `h` rows of
    its own while the rays are unprojected in the whole frame: `y0` is
    the band's first global row and `full_h` the frame's height, or
    `y_rows` ([h] ints) maps each local row to its global row (the cyclic
    tile-row interleave). The planes themselves do not depend on where
    the band lies.
    """
    return shade_pack(mask, z, lin, bg_fb, scene.cm, eye, tick,
                      shader_idx=shader_idx, per_pixel=True,
                      ray_world=ray_world, rows=rows, block_w=block_w, y0=y0,
                      full_h=full_h, y_rows=y_rows)


def _shade_deferred(queue, scene: Scene, z, slot, rows_flat, n2: int,
                    n3: int, eye, tick, shader_idx: int, bg_fb, w: int,
                    h: int, per_pixel: bool, ray_world: bool):
    """Shading from kernel B7's (z, slot): re-evaluate the WINNING pair
    only (rustexp_tpu/raster/pipeline.py:594).

    (z, slot) are compacted to the queue's occupied blocks, each pixel's
    winning pair is fetched with one rows_flat[slot] gather (the zero
    sentinel row where nobody won), and the edges, barycentrics and
    attribute planes are re-evaluated with the kernels' formulas on the
    same integers: the frame of the planes path (defer=False), bit for bit,
    at one evaluation per pixel instead of one per pair.
    """
    block_w = queue.shade_w
    ntx = w // block_w
    rows_g, _, comp = _blocks(queue.rows, w, h, block_w)
    slotc = comp(slot)
    maskc = slotc >= 0
    sentinel = rows_flat.shape[0] - 1
    px = rows_flat[torch.where(maskc, slotc, sentinel).reshape(-1).long()]
    shape = (-1,) + tuple(slotc.shape)                    # [CH, Rc, block_w]
    ci = px[:, :_I_CH].view(torch.int32).T.reshape(shape)
    cf = px[:, _I_CH:].T.reshape(shape)
    ys = torch.div(rows_g, ntx, rounding_mode="floor").to(torch.int32)[:, None]
    xs = ((rows_g % ntx) * block_w).to(torch.int32)[:, None] \
        + torch.arange(block_w, dtype=torch.int32, device=z.device)[None, :]
    _, linc = _eval_pairs(ci, cf, xs, ys, n2, n3, planes=True)
    zc = comp(z) if per_pixel and ray_world else None
    return shade_pack(maskc, zc, linc, bg_fb, scene.cm, eye, tick,
                      shader_idx=shader_idx, per_pixel=per_pixel,
                      ray_world=ray_world, rows=queue.rows, block_w=block_w,
                      compact=True)


# ---------------------------------------------------------------------------
# Backgrounds and the cubemap-cross overlay
# ---------------------------------------------------------------------------


def background(bg_idx: int, w: int, h: int, device: torch.device,
               y0: int = 0, full_h: int | None = None, y_rows=None):
    """Vertical gradient packed without gamma, int32 [h, w]
    (rustexp_tpu/raster/pipeline.py:774; rasterizer.rs:1268-1299).
    Evaluated on the host (a CUDA division by a scalar multiplies by its
    reciprocal) and copied to `device`. `y0`/`full_h` evaluate a band of
    a taller frame's gradient at its global rows (the band renderers);
    `y_rows` ([h] ints, in place of y0) gives each local row its global
    row, as the cyclic tile-row interleave needs."""
    start, end = BACKGROUNDS[bg_idx]
    ys = (torch.arange(y0, y0 + h, dtype=torch.float32) if y_rows is None
          else torch.as_tensor(y_rows).to("cpu", torch.float32))
    pos = ys / float((h if full_h is None else full_h) - 1)
    col = (torch.tensor(start)[None, :] * (1.0 - pos)[:, None]
           + torch.tensor(end)[None, :] * pos[:, None])
    row = pack_abgr32(col[:, 0], col[:, 1], col[:, 2])
    return trace.upload("background", row[:, None].expand(h, w).contiguous(),
                        device)


def overlay_cross(fb, cross):
    """Blit the unfolded-cubemap preview at (10, 10), skipping alpha-0
    pixels (rustexp_tpu/raster/pipeline.py:842; rasterizer.rs:529-551)."""
    h, w = fb.shape
    ch, cw = cross.shape
    x1, y1 = min(10, w), min(10, h)
    x2, y2 = min(x1 + cw, w), min(y1 + ch, h)
    if x2 <= x1 or y2 <= y1:
        return fb
    sub = cross[0:y2 - y1, 0:x2 - x1]
    out = fb.clone()
    alpha = sub & -0x1000000  # the 0xFF000000 alpha byte, as int32
    out[y1:y2, x1:x2] = torch.where(alpha != 0, sub, fb[y1:y2, x1:x2])
    return out


_WHITE = 0x00FFFFFF


def _set_white(fb, x, y, ok):
    """fb with every (x, y) sample where `ok` set to white.

    The JAX package writes every sample, sending the dead ones to (0, 0)
    with that pixel's old value; with duplicate indices its (0, 0)
    depends on the scatter's order. Here only live samples write, and all
    of them the same value, so the result depends on no order (ROADMAP C).
    Dead samples go to a pad word past the frame, so no mask leaves the
    device."""
    h, w = fb.shape
    flat = torch.where(ok, y * w + x, h * w).reshape(-1).long()
    out = torch.cat([fb.reshape(-1), fb.new_zeros(1)])
    out.index_fill_(0, flat, _WHITE)
    return out[:h * w].view(h, w)


def draw_points(fb, vp, tris, w: int, h: int):
    """Point mode: one white dot per referenced vertex
    (rustexp_tpu/raster/pipeline.py:796; rasterizer.rs:2013-2028).
    trunc_i32 is XLA's saturating convert (NaN -> 0), so a vertex lands
    on the pixel the JAX package's astype(int32) gives on every device."""
    idx = tris.reshape(-1).long()
    x, y = trunc_i32(vp[idx, 0]), trunc_i32(vp[idx, 1])
    return _set_white(fb, x, y, (x >= 0) & (x < w) & (y >= 0) & (y < h))


def draw_lines(fb, vp, tris, w: int, h: int, max_steps: int | None = None):
    """Wireframe by a vectorized DDA (rustexp_tpu/raster/pipeline.py:807;
    rasterizer.rs:1301-1329): every edge takes max_steps samples at unit
    max-axis spacing, masked beyond its length. ``a + step * m`` and
    ``d / max(s, 1e-30)`` round once per op, as JAX's source writes them:
    keep them eager (no fused multiply-add)."""
    if max_steps is None:
        max_steps = 2 * max(w, h)
    t = tris.long()
    edges = torch.cat([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])  # [E, 2]
    p1, p2 = vp[edges[:, 0], 0:2], vp[edges[:, 1], 0:2]
    # a canonical direction, so both windings draw the same pixels
    swap = (p2[:, 0] <= p1[:, 0])[:, None]
    a, b = torch.where(swap, p2, p1), torch.where(swap, p1, p2)
    d = b - a
    s = torch.maximum(d[:, 0].abs(), d[:, 1].abs())
    step = d / torch.maximum(s, s.new_tensor(1e-30))[:, None]
    m = torch.arange(max_steps, dtype=torch.float32, device=vp.device)
    pts = a[:, None, :] + step[:, None, :] * m[None, :, None]  # [E, K, 2]
    x, y = trunc_i32(pts[..., 0]), trunc_i32(pts[..., 1])
    ok = (m[None, :] < s[:, None]) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return _set_white(fb, x, y, ok)


# ---------------------------------------------------------------------------
# Frame orchestration
# ---------------------------------------------------------------------------


def render_frame(scene: Scene, eye, tick, *, w: int, h: int,
                 mode: int = MODE_FILL, per_pixel: bool = False,
                 shader_idx: int = 5, bg_idx: int = 0,
                 show_cm: bool | None = None,
                 structure: rs.Structure | None = None,
                 return_overflow: bool = False):
    """Render one frame -> uint32 ABGR [h, w], bottom-left origin
    (rustexp_tpu/raster/pipeline.py:997).

    `structure` (raster/structure.py) picks the path: a QUEUE takes the
    flat queue, BINS the bins at its (cap, spans, rows_cap) (None bins by
    the dense coverage matrix with capacity T), ORACLE the G-buffer
    oracle (raster_gbuffer_xla + shade_gbuffer, any size, no kernel).
    Without one, the dense bins where their tiles fit the frame, else
    the oracle. ``mode`` MODE_POINT or MODE_LINE draws the vertices or
    the edges over the background instead (draw_points, draw_lines: no
    shader, no raster kernel, no structure read). With
    return_overflow=True returns (fb, overflow): the cached queue went
    stale, or the static bins overflowed (always False for points and
    lines); rebuild and render again.
    """
    if structure is None:
        structure = rs.Structure(rs.route(len(scene.tris), w, h, rs.BINS))
    with trace.span("raster.frame"):
        if show_cm is None:
            show_cm = sh.shader_uses_cm(shader_idx)
        fb = background(bg_idx, w, h, scene.cp3.device)
        no_overflow = torch.zeros((), dtype=torch.bool, device=fb.device)
        if mode in (MODE_POINT, MODE_LINE):
            vp, _, _ = transform_vertices(scene, eye, w, h)
            draw = draw_points if mode == MODE_POINT else draw_lines
            fb, overflow = draw(fb, vp, scene.tris, w, h), no_overflow
        elif structure.kind == rs.QUEUE:
            sh.shader_fn(shader_idx)  # a bad index raises before any work
            colors = None
            if not per_pixel:
                with trace.span("raster.shade"):
                    colors = vertex_colors(scene, eye, tick, w, h,
                                           shader_idx)
            fb, overflow = raster_and_shade_queue(
                scene, structure.data, colors, eye, tick, w=w, h=h,
                per_pixel=per_pixel, shader_idx=shader_idx, bg_fb=fb)
        else:
            fb, overflow = _bins_or_oracle(
                scene, eye, tick, w, h, per_pixel, shader_idx, fb, structure,
                no_overflow)
        if show_cm:
            with trace.span("raster.shade"):
                fb = overlay_cross(fb, scene.cross)
        fb = fb.view(torch.uint32)
    return (fb, overflow) if return_overflow else fb


def _bins_or_oracle(scene: Scene, eye, tick, w: int, h: int, per_pixel: bool,
                    shader_idx: int, bg_fb, structure, no_overflow):
    """render_frame's Fill frame through the bins (kernel B2) or the
    G-buffer oracle -> (fb int32, overflow). In V mode the shader runs on
    the world-space vertices before the bins' channels take its colours,
    so such a frame opens raster.setup twice, around the shade."""
    shader = sh.shader_fn(shader_idx)
    bins = structure.kind == rs.BINS
    with trace.span("raster.setup"):
        with trace.span("raster.transform"):
            vp, world, n_world = transform_vertices(scene, eye, w, h)
        setup = setup_triangles(vp, scene.tris, w, h)
        if bins and per_pixel:
            chans = bins_attr_channels(scene, vp, world, n_world,
                                       scene.colors, per_pixel=True)
    colors = scene.colors
    if not per_pixel:
        with trace.span("raster.shade"):
            colors = shader(world, n_world, scene.colors,
                            _device_eye(eye, world.device), tick, scene.cm)
        if bins:
            with trace.span("raster.setup"):
                chans = bins_attr_channels(scene, vp, world, n_world, colors,
                                           per_pixel=False)
    if bins:
        cap, spans, rows_cap = structure.data or (None, None, None)
        return raster_and_shade_pallas(
            scene, setup, *chans, eye, tick, w=w, h=h, per_pixel=per_pixel,
            shader_idx=shader_idx, bg_fb=bg_fb, cap=cap, spans=spans,
            rows_cap=rows_cap)
    with trace.span("raster.kernel"):
        gb = raster_gbuffer_xla(setup, h, w)
    with trace.span("raster.shade"):
        fb = shade_gbuffer(gb, scene, vp, world, n_world, colors, eye, tick,
                           per_pixel=per_pixel, shader_idx=shader_idx,
                           bg_fb=bg_fb)
    return fb, no_overflow

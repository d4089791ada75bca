"""The frame pipeline: vertex transform -> raster -> deferred shade -> pack.

Port of rustexp_tpu/raster/pipeline.py for the Fill frame, with its
three raster backends:

* the flat queue (``backend="queue"`` with a prebuilt queue; the
  benchmark's path for meshes of >= 1,000 triangles):
  transform_corners_planar (fixed-order per-op f32 matrix products on
  corner-major [3, 4, T] planes, reference rasterizer.rs:1181-1231) ->
  setup_triangles_planar -> build_queue (cached across frames by the
  callers, or built every frame by the moving camera,
  app.benchmark.moving_frame) -> raster_attrs_queue (kernel B1 on the
  card) ->
  _shade_compacted over the queue's shade blocks; or, with defer=True,
  raster_zslot_queue (kernel B7, the depth race alone) ->
  _shade_deferred, which re-evaluates each pixel's winning pair;
* the bins (``backend="pallas"``, and ``"auto"``/``"queue"`` on tileable
  frames without a queue; smaller meshes): transform_vertices ->
  setup_triangles -> bin_triangles/bin_pairs -> raster_attrs_bins
  (kernel B2 on the card) -> a full-frame shade, or _shade_compacted over
  the occupied blocks when ``raster_rows`` is given;
* the G-buffer oracle (``backend="xla"``, and every frame of partial
  32x128 tiles): setup_triangles -> raster_gbuffer_xla (plain torch, any
  size) -> shade_gbuffer. The band renderer (parallel/raster_shard.py)
  shades the same G-buffer from kernel B3 (raster_gbuffer_pallas).

All end in core.colors.pack_abgr32_gamma_arith. The 4x4 camera matrices
are computed on the host in float32 torch (one rounding per op, as the
reference does) and copied to the frame's device, so a frame is
bit-identical on the CPU and on the card. Point and line modes
(draw_points, draw_lines) draw white dots or DDA wireframes over the
background with no raster kernel and no shader.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import trace
from ..core.colors import pack_abgr32, pack_abgr32_gamma_arith, trunc_i32
from ..ops import raster_bins as rb
from ..ops.ieee import lerp_2mad, lerp_3w
from ..ops.raster_queue import (_I_CH, SHADE_W, _eval_pairs, build_queue,
                                choose_shade_w, raster_attrs_queue,
                                raster_zslot_queue, read_queue_stats,
                                suggest_queue_config)
from ..ops.raster_setup import setup_triangles, setup_triangles_planar
from ..ops.raster_xla import raster_gbuffer_xla
from . import shaders as sh

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


def _cross3_exact(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _mm4_exact(a, b):
    """Fixed-order 4x4 @ 4x4: s = a[i,0]*b[0,j]; s += a[i,1]*b[1,j]; ..."""
    s = a[:, 0:1] * b[0:1, :]
    s = s + a[:, 1:2] * b[1:2, :]
    s = s + a[:, 2:3] * b[2:3, :]
    return s + a[:, 3:4] * b[3:4, :]


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


def _host_eye(eye) -> torch.Tensor:
    if isinstance(eye, torch.Tensor):
        return eye.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(eye, np.float32))


def _device_eye(eye, device) -> torch.Tensor:
    """The eye as f32 [3] on `device` (the span sync.upload.eye)."""
    return trace.upload("eye", _host_eye(eye), device)


def look_at(eye, at, up):
    """Reference look_at (rasterizer.rs:1236-1245): division-form
    normalize, left-to-right dots, translation column dot(-eye, axis)."""
    za = eye - at
    za = za / torch.sqrt(_dot3_exact(za, za))
    xa = _cross3_exact(up, za)
    xa = xa / torch.sqrt(_dot3_exact(xa, xa))
    ya = _cross3_exact(za, xa)
    ne = -eye
    return torch.stack([
        torch.stack([xa[0], xa[1], xa[2], _dot3_exact(ne, xa)]),
        torch.stack([ya[0], ya[1], ya[2], _dot3_exact(ne, ya)]),
        torch.stack([za[0], za[1], za[2], _dot3_exact(ne, za)]),
        torch.tensor([0.0, 0.0, 0.0, 1.0]),
    ])


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


def _world_to_vp_exact(eye, w: int, h: int):
    """(viewport @ perspective) @ look_at in the oracle's m4_mul order."""
    return _mm4_exact(
        _mm4_exact(viewport_matrix(w, h), perspective(45.0, w / h, 0.1, 10.0)),
        look_at(eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])))


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
    return _mm4_exact(_mm4_exact(inv_look, inv_persp), inv_vpm)


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
    """
    with trace.span("raster.setup"):
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
            return fb, stale

        wr = 1.0 / lin[0]
        c = [q * wr for q in lin[1:4]]
        packed = pack_abgr32_gamma_arith(c[0], c[1], c[2])
        return torch.where(mask, packed, bg_fb), stale


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

    The name is the JAX package's, as ``render_frame(backend="pallas")``
    is public API. With per_pixel and ``rows_cap``, the shade runs only on
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

        wr = 1.0 / lin[0]

        def ch_last(ps):
            return torch.stack([q * wr for q in ps], dim=-1)

        out = ch_last(lin[1:4])
        if per_pixel:
            out = sh.shader_fn(shader_idx)(ch_last(lin[4:7]),
                                           ch_last(lin[7:10]), out,
                                           _device_eye(eye, z.device), tick,
                                           scene.cm)
        packed = pack_abgr32_gamma_arith(out[..., 0], out[..., 1],
                                         out[..., 2])
        return torch.where(mask, packed, bg_fb), overflow


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


def _shade_blocks(rows, rows_g, padr, maskc, zc, linc, scene: Scene, eye,
                  tick, shader_idx: int, bg_fb, w: int, h: int, block_w: int,
                  per_pixel: bool, ray_world: bool, y0: int = 0,
                  full_h: int | None = None, y_rows=None):
    """Shade compacted blocks and scatter them over the background:
    _shade_compacted's and _shade_deferred's common tail
    (rustexp_tpu/raster/pipeline.py:661-687, 737-766).

    maskc, zc and the planes linc are [Rc, block_w] over the blocks
    `rows` lists (rows_g and padr from _blocks). V mode interpolates
    colors only; per-pixel shades, with world positions unprojected from
    each pixel's (x, y, z) and 1/w (ray_world) or interpolated (linc[4:7],
    normals linc[7:10]). The rays of a band are unprojected at global
    rows: local row y is y0 + y of a full_h-row frame, or y_rows[y].
    """
    ntx = w // block_w
    n_blk = h * ntx
    wrc = 1.0 / linc[0]
    out = torch.stack([p_ * wrc for p_ in linc[1:4]], dim=-1)
    if per_pixel:
        if ray_world:
            nc = torch.stack([p_ * wrc for p_ in linc[4:7]], dim=-1)
            ly = torch.div(rows_g, ntx, rounding_mode="floor")
            if y_rows is None:
                yc = (ly + y0).to(torch.float32)[:, None]
            else:
                yc = trace.upload(
                    "rows", torch.as_tensor(y_rows).to(torch.float32),
                    zc.device)[ly][:, None]
            xc = ((rows_g % ntx) * block_w).to(torch.float32)[:, None] \
                + torch.arange(block_w, dtype=torch.float32,
                               device=zc.device)[None, :]
            M = inv_world_to_vp(eye, w, h if full_h is None
                                else full_h).tolist()
            pc = torch.stack(
                [wrc * (M[i][0] * xc + M[i][1] * yc + M[i][2] * zc + M[i][3])
                 for i in range(3)], dim=-1)
        else:
            pc = torch.stack([p_ * wrc for p_ in linc[4:7]], dim=-1)
            nc = torch.stack([p_ * wrc for p_ in linc[7:10]], dim=-1)
        out = sh.shader_fn(shader_idx)(pc, nc, out,
                                       _device_eye(eye, wrc.device), tick,
                                       scene.cm)
    packed = pack_abgr32_gamma_arith(out[..., 0], out[..., 1], out[..., 2])

    bgv = bg_fb.reshape(n_blk, block_w)
    merged = torch.where(maskc, packed, bgv[rows_g])
    # pads scatter into one extra row that is dropped; rows are unique
    buf = torch.cat([bgv, bgv[:1]])
    buf[torch.where(padr, n_blk, rows).long()] = merged
    return buf[:n_blk].reshape(h, w)


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
    rows_g, padr, comp = _blocks(rows, w, h, block_w)
    return _shade_blocks(rows, rows_g, padr, comp(mask),
                         comp(z) if ray_world else None,
                         [comp(p_) for p_ in lin], scene, eye, tick,
                         shader_idx, bg_fb, w, h, block_w, True, ray_world,
                         y0=y0, full_h=full_h, y_rows=y_rows)


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
    rows_g, padr, comp = _blocks(queue.rows, w, h, block_w)
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
    return _shade_blocks(queue.rows, rows_g, padr, maskc, zc, linc, scene,
                         eye, tick, shader_idx, bg_fb, w, h, block_w,
                         per_pixel, ray_world)


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


def _queue_setup(scene: Scene, eye, w: int, h: int):
    xs, ys, zs, _, _, _ = transform_corners_planar(scene, eye, w, h)
    return setup_triangles_planar(xs, ys, zs, w, h)


def scene_queue_stats(scene: Scene, eye, w: int, h: int) -> tuple:
    """queue_stats of this scene at `eye` on the frame's planar setup, as
    five Python ints read back at once (rustexp_tpu/raster/pipeline.py:921
    _queue_stats_jit): the chunk count, the largest tile spans and the
    occupied fine and tile-wide shade blocks."""
    return read_queue_stats(_queue_setup(scene, eye, w, h), h, w)


def build_scene_queue(scene: Scene, eye, w: int, h: int,
                      margin: float = 1.3, per_pixel: bool = True,
                      shade_w: int | None = None):
    """Measure + build the flat raster queue for this scene/viewpoint
    (rustexp_tpu/raster/pipeline.py:948): one read of queue_stats for
    the static caps (`margin` on the chunk count), then build_queue
    with its "auto" order. The compacted-shade width is choose_shade_w's
    unless `shade_w` is given. The build uses the same planar setup as
    the frame, so no triangle can snap into a tile the structure never
    enumerated. The span structure.queue holds it all."""
    with trace.span("structure.queue"):
        setup = _queue_setup(scene, eye, w, h)
        stats = read_queue_stats(setup, h, w)
        if shade_w is None:
            shade_w = choose_shade_w(stats[3], stats[4], per_pixel=per_pixel)
        occ = stats[3] if shade_w == SHADE_W else stats[4]
        s_cap, m_y, m_x, t_cap = suggest_queue_config(stats[:3] + (occ,),
                                                      margin=margin)
        return build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                           t_cap=t_cap, shade_w=shade_w)


def _bins_setup(scene: Scene, eye, w: int, h: int):
    vp, _, _ = transform_vertices(scene, eye, w, h)
    return setup_triangles(vp, scene.tris, w, h)


def _bin_stats(scene: Scene, eye, w: int, h: int):
    """(largest bin, max span_x, max span_y, occupied SHADE_W blocks) as
    0-d tensors (rustexp_tpu/raster/pipeline.py:872).

    A block (y, bx) can hold coverage only if some valid triangle's
    clipped AABB meets it: one [h, T] x [T, ntx] product of 0/1 matrices.
    Its sums are exact in float32 (and in TF32, were it switched on), so
    the > 0 test does not depend on the matmul precision.
    """
    setup = _bins_setup(scene, eye, w, h)
    sx, sy = rb.max_spans(setup, h, w)
    ntx = -(-w // SHADE_W)
    i32 = dict(dtype=torch.int32, device=setup.valid.device)
    ys = torch.arange(h, **i32)
    occ_y = ((ys[:, None] >= setup.min_y[None, :])
             & (ys[:, None] < setup.max_y[None, :]))           # [h, T]
    tx0 = torch.arange(ntx, **i32) * SHADE_W
    occ_x = ((tx0[None, :] < setup.max_x[:, None])
             & (tx0[None, :] + SHADE_W > setup.min_x[:, None])
             & setup.valid[:, None])                           # [T, ntx]
    occ = torch.matmul(occ_y.to(torch.float32), occ_x.to(torch.float32)) > 0
    return rb.max_bin_count(setup, h, w), sx, sy, occ.sum(dtype=torch.int32)


def suggest_binning(scene: Scene, eye, w: int, h: int, margin: float = 1.3):
    """(cap, (m_x, m_y), rows_cap) for the bins backend, one host read
    (rustexp_tpu/raster/pipeline.py:895).

    The span margin (+1 tile each way) absorbs camera motion; bin_pairs
    still reports ``overflow`` if a frame exceeds it. rows_cap bounds
    the occupied shade blocks (render_frame's raster_rows) with the same
    margin, or is None when >= 75% of the frame's blocks can be occupied
    (compaction then costs more than the shade it skips). The span
    structure.bins holds the device work and its read.
    """
    with trace.span("structure.bins"):
        stats = torch.stack(_bin_stats(scene, eye, w, h))
        with trace.span("sync.read.bin_stats"):
            mc, sx, sy, rc = stats.tolist()
    need = max(512, int(mc * margin))
    cap = (need + 511) // 512 * 512
    ntx = -(-w // SHADE_W)
    rows_cap = min(h * ntx, max(64, (int(rc * margin) + 63) // 64 * 64))
    if rows_cap >= (h * ntx * 3) // 4:
        rows_cap = None
    return cap, (sx + 1, sy + 1), rows_cap


def suggest_cap(scene: Scene, eye, w: int, h: int, margin: float = 1.3) -> int:
    """A bin capacity for this scene and viewpoint: the largest bin with a
    margin, rounded up to 512 (rustexp_tpu/raster/pipeline.py:976)."""
    m = rb.max_bin_count(_bins_setup(scene, eye, w, h), h, w)
    with trace.span("sync.read.bin_cap"):
        m = int(m)
    need = max(512, int(m * margin))
    return (need + 511) // 512 * 512


def render_frame(scene: Scene, eye, tick, *, w: int, h: int,
                 mode: int = MODE_FILL, per_pixel: bool = False,
                 shader_idx: int = 5, bg_idx: int = 0,
                 show_cm: bool | None = None, backend: str = "auto",
                 raster_cap: int | None = None,
                 raster_spans: tuple | None = None,
                 raster_rows: int | None = None,
                 raster_queue=None, return_overflow: bool = False):
    """Render one frame -> uint32 ABGR [h, w], bottom-left origin
    (rustexp_tpu/raster/pipeline.py:997).

    The dispatch is the JAX package's: ``backend="queue"`` with a
    prebuilt `raster_queue` (build_scene_queue) takes the flat queue;
    ``"pallas"``, and ``"auto"``/``"queue"`` on a frame of whole 32x128
    tiles, take the bins with ``raster_cap``/``raster_spans``/
    ``raster_rows`` (suggest_binning; None bins by the dense coverage
    matrix with capacity T); ``"xla"``, and every other frame, the
    G-buffer oracle (raster_gbuffer_xla + shade_gbuffer, any size, no
    kernel). ``mode`` MODE_POINT or MODE_LINE draws the vertices or the
    edges over the background instead (draw_points, draw_lines: no
    shader, no raster kernel, no structure read). With
    return_overflow=True returns (fb, overflow): the cached queue went
    stale, or the static bins overflowed (always False for points and
    lines); rebuild and render again.
    """
    with trace.span("raster.frame"):
        if show_cm is None:
            show_cm = sh.shader_uses_cm(shader_idx)
        fb = background(bg_idx, w, h, scene.cp3.device)
        no_overflow = torch.zeros((), dtype=torch.bool, device=fb.device)
        if mode in (MODE_POINT, MODE_LINE):
            vp, _, _ = transform_vertices(scene, eye, w, h)
            draw = draw_points if mode == MODE_POINT else draw_lines
            fb, overflow = draw(fb, vp, scene.tris, w, h), no_overflow
        elif backend == "queue" and raster_queue is not None:
            sh.shader_fn(shader_idx)  # a bad index raises before any work
            colors = None
            if not per_pixel:
                with trace.span("raster.shade"):
                    colors = vertex_colors(scene, eye, tick, w, h,
                                           shader_idx)
            fb, overflow = raster_and_shade_queue(
                scene, raster_queue, colors, eye, tick, w=w, h=h,
                per_pixel=per_pixel, shader_idx=shader_idx, bg_fb=fb)
        else:
            fb, overflow = _bins_or_oracle(
                scene, eye, tick, w, h, per_pixel, shader_idx, fb, backend,
                raster_cap, raster_spans, raster_rows, no_overflow)
        if show_cm:
            with trace.span("raster.shade"):
                fb = overlay_cross(fb, scene.cross)
        fb = fb.view(torch.uint32)
    return (fb, overflow) if return_overflow else fb


def _bins_or_oracle(scene: Scene, eye, tick, w: int, h: int, per_pixel: bool,
                    shader_idx: int, bg_fb, backend: str, cap, spans,
                    rows_cap, no_overflow):
    """render_frame's Fill frame without a queue -> (fb int32, overflow):
    the bins (kernel B2) or, on frames of partial tiles and with backend
    "xla", the G-buffer oracle. In V mode the shader runs on the
    world-space vertices before the bins' channels take its colours, so
    such a frame opens raster.setup twice, around the shade."""
    shader = sh.shader_fn(shader_idx)
    tileable = h % rb.TILE_H == 0 and w % rb.TILE_W == 0
    bins = backend == "pallas" or (backend in ("auto", "queue") and tileable)
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

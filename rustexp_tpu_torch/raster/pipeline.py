"""The frame pipeline: vertex transform -> queue raster -> deferred shade -> pack.

Port of rustexp_tpu/raster/pipeline.py for the flat-queue Fill frame
(the benchmark's main path for meshes of >= 1,000 triangles):

  1. transform_corners_planar: fixed-order per-op f32 matrix products on
     corner-major [3, 4, T] planes (reference rasterizer.rs:1181-1231);
  2. ops.raster_setup.setup_triangles_planar;
  3. ops.raster_queue.build_queue (cached across frames by the callers);
  4. ops.raster_queue.raster_attrs_queue: kernel B1 on the card;
  5. _shade_compacted: per-pixel shading over occupied shade blocks only;
  6. core.colors.pack_abgr32_gamma_arith.

The 4x4 camera matrices are computed on the host in float32 torch (one
rounding per op, as the reference does) and copied to the frame's
device, so a frame is bit-identical on the CPU and on the card. Point
and line modes, the bins backend and the deferred-z variant raise
NotImplementedError with their ROADMAP items.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.colors import pack_abgr32, pack_abgr32_gamma_arith
from ..ops.raster_queue import (SHADE_W, build_queue, choose_shade_w,
                                queue_stats, raster_attrs_queue,
                                suggest_queue_config)
from ..ops.raster_setup import setup_triangles_planar
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
    """Scene from rustexp_tpu.assets.mesh.MeshData + a CubeMapSet
    (rustexp_tpu/raster/pipeline.py:74), on `device`."""
    ndim = mesh.normalize_dimensions()
    it33 = np.linalg.inv(ndim).T[:3, :3].astype(np.float32)
    tris = np.asarray(mesh.tris)
    pos = np.asarray(mesh.positions)
    nrm = np.asarray(mesh.normals)
    col = np.asarray(mesh.colors)
    posh = np.concatenate([pos, np.ones((pos.shape[0], 1), np.float32)],
                          axis=1)

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


def transform_vertices(scene: Scene, eye, w: int, h: int):
    """Mesh space -> (viewport vp with 1/w, world positions, world normals)
    per vertex (rustexp_tpu/raster/pipeline.py:270), including the
    reference's viewport-before-divide quirk."""
    m = _world_to_vp_exact(_host_eye(eye), w, h).to(scene.positions.device)
    pos_h = torch.cat([scene.positions,
                       scene.positions.new_ones((scene.positions.shape[0], 1))],
                      dim=1)
    world_h = _mv4_exact(scene.ndim, pos_h.T).T
    clip = _mv4_exact(m, world_h.T).T
    inv_w = 1.0 / clip[:, 3]
    vp = torch.cat([clip[:, :3] * inv_w[:, None], inv_w[:, None]], dim=1)
    n_world = _mv3_exact(scene.it33, scene.normals.T).T
    return vp, world_h[:, :3], n_world


def transform_corners_planar(scene: Scene, eye, w: int, h: int):
    """Corner-major planar transform (rustexp_tpu/raster/pipeline.py:300).

    Returns (xs, ys, zs, iw, n, world): f32 [3, T] viewport coordinates
    per corner and [3, 3, T] world normals / positions.
    """
    m = _world_to_vp_exact(_host_eye(eye), w, h).to(scene.cp3.device)
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
    eye_d = _host_eye(eye).to(world.device)
    return sh.shader_fn(shader_idx)(world, n_world, scene.colors, eye_d,
                                    tick, scene.cm)


def queue_attr_channels(scene: Scene, colors, eye, w: int, h: int, *,
                        per_pixel: bool):
    """Triangle setup and the kernel's attribute channels for one frame
    -> (setup, extra, n2, n3) (rustexp_tpu/raster/pipeline.py:535-570,
    ray_world=True).

    `colors` is the per-vertex shaded colors in V mode, None in per-pixel
    mode (the baked corner colors are static). The n2 = 4 two-MAD planes
    are 1/w and RGB/w; per-pixel adds n3 = 3 normal planes (world
    positions are unprojected from the pixel, not interpolated).
    """
    xs, ys, zs, iw, n_c, _ = transform_corners_planar(scene, eye, w, h)
    setup = setup_triangles_planar(xs, ys, zs, w, h)
    one = torch.ones_like(iw[0])

    if per_pixel:
        crows = [scene.cc3[0], scene.cc3[1], scene.cc3[2]]   # [3, T] each
    else:
        crows = [colors[scene.tris[:, j]].T for j in range(3)]

    def base_d(j):
        return [one, crows[j][0], crows[j][1], crows[j][2]]

    # attr_channels_2mad in planar form: (base, d10, d20) per channel,
    # every product rounded before the subtraction (oracle.cpp:1242-1243)
    base = [q * iw[0] for q in base_d(0)]
    d10 = [q * iw[1] - b for q, b in zip(base_d(1), base)]
    d20 = [q * iw[2] - b for q, b in zip(base_d(2), base)]
    extra = base + d10 + d20
    n2, n3 = 4, 0
    if per_pixel:
        # attr_channels_3w planar: (q*iw0, q*iw1, q*iw2) normal triples
        extra = extra + [n_c[0, k] * iw[0] for k in range(3)] \
            + [n_c[1, k] * iw[1] for k in range(3)] \
            + [n_c[2, k] * iw[2] for k in range(3)]
        n3 = 3
    return setup, extra, n2, n3


def raster_and_shade_queue(scene: Scene, queue, colors, eye, tick, *,
                           w: int, h: int, per_pixel: bool, shader_idx: int,
                           bg_fb):
    """Flat-queue Fill path (rustexp_tpu/raster/pipeline.py:501, with the
    defaults ray_world=True, defer=False). Returns (fb int32 [h, w], stale).
    """
    setup, extra, n2, n3 = queue_attr_channels(scene, colors, eye, w, h,
                                               per_pixel=per_pixel)
    z, mask, lin, stale = raster_attrs_queue(queue, setup, extra, n2, n3, h, w)
    if per_pixel:
        fb = _shade_compacted(queue.rows, scene, z, mask, lin, eye, tick,
                              shader_idx, bg_fb, w, h, block_w=queue.shade_w)
        return fb, stale

    wr = 1.0 / lin[0]
    c = [q * wr for q in lin[1:4]]
    packed = pack_abgr32_gamma_arith(c[0], c[1], c[2])
    return torch.where(mask, packed, bg_fb), stale


def _shade_compacted(rows, scene: Scene, z, mask, lin, eye, tick,
                     shader_idx: int, bg_fb, w: int, h: int, block_w: int):
    """Deferred per-pixel shading over OCCUPIED shade blocks only
    (rustexp_tpu/raster/pipeline.py:690, whole frame, ray_world=True).

    `rows` (int32 [Rc], entries >= h*(w//block_w) are padding) lists the
    block_w-wide row spans that can hold coverage; the planes are gathered
    to [Rc, block_w], shaded there, and scattered back over the background.
    World positions are unprojected from each pixel's (x, y, z) and its
    interpolated 1/w.
    """
    ntx = w // block_w
    n_blk = h * ntx
    padr = rows >= n_blk
    rows_g = torch.where(padr, 0, rows).long()

    def comp(plane):
        return plane.reshape(n_blk, block_w)[rows_g]       # [Rc, block_w]

    maskc = comp(mask)
    wrc = 1.0 / comp(lin[0])
    cc = torch.stack([comp(p_) * wrc for p_ in lin[1:4]], dim=-1)
    nc = torch.stack([comp(p_) * wrc for p_ in lin[4:7]], dim=-1)
    zc = comp(z)
    yc = torch.div(rows_g, ntx, rounding_mode="floor").to(
        torch.float32)[:, None]
    xc = ((rows_g % ntx) * block_w).to(torch.float32)[:, None] \
        + torch.arange(block_w, dtype=torch.float32, device=z.device)[None, :]
    M = inv_world_to_vp(eye, w, h).tolist()
    pc = torch.stack(
        [wrc * (M[i][0] * xc + M[i][1] * yc + M[i][2] * zc + M[i][3])
         for i in range(3)], dim=-1)
    eye_d = _host_eye(eye).to(z.device)
    out = sh.shader_fn(shader_idx)(pc, nc, cc, eye_d, tick, scene.cm)
    packed = pack_abgr32_gamma_arith(out[..., 0], out[..., 1], out[..., 2])

    bgv = bg_fb.reshape(n_blk, block_w)
    merged = torch.where(maskc, packed, bgv[rows_g])
    # pads scatter into one extra row that is dropped; rows are unique
    buf = torch.cat([bgv, bgv[:1]])
    buf[torch.where(padr, n_blk, rows).long()] = merged
    return buf[:n_blk].reshape(h, w)


# ---------------------------------------------------------------------------
# Backgrounds and the cubemap-cross overlay
# ---------------------------------------------------------------------------


def background(bg_idx: int, w: int, h: int, device: torch.device):
    """Vertical gradient packed without gamma, int32 [h, w]
    (rustexp_tpu/raster/pipeline.py:774; rasterizer.rs:1268-1299).
    Evaluated on the host (a CUDA division by a scalar multiplies by its
    reciprocal) and copied to `device`."""
    start, end = BACKGROUNDS[bg_idx]
    pos = torch.arange(h, dtype=torch.float32) / float(h - 1)
    col = (torch.tensor(start)[None, :] * (1.0 - pos)[:, None]
           + torch.tensor(end)[None, :] * pos[:, None])
    row = pack_abgr32(col[:, 0], col[:, 1], col[:, 2])
    return row[:, None].expand(h, w).contiguous().to(device)


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


# ---------------------------------------------------------------------------
# Frame orchestration
# ---------------------------------------------------------------------------


def _queue_setup(scene: Scene, eye, w: int, h: int):
    xs, ys, zs, _, _, _ = transform_corners_planar(scene, eye, w, h)
    return setup_triangles_planar(xs, ys, zs, w, h)


def build_scene_queue(scene: Scene, eye, w: int, h: int,
                      per_pixel: bool = True):
    """Measure + build the flat raster queue for this scene/viewpoint
    (rustexp_tpu/raster/pipeline.py:948, _queue_stats_jit :921). The build
    uses the same planar setup as the frame, so no triangle can snap into
    a tile the structure never enumerated."""
    setup = _queue_setup(scene, eye, w, h)
    stats = tuple(int(x) for x in queue_stats(setup, h, w))
    shade_w = choose_shade_w(stats[3], stats[4], per_pixel=per_pixel)
    occ = stats[3] if shade_w == SHADE_W else stats[4]
    s_cap, m_y, m_x, t_cap = suggest_queue_config(stats[:3] + (occ,))
    return build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                       t_cap=t_cap, shade_w=shade_w)


def render_frame(scene: Scene, eye, tick, *, w: int, h: int,
                 mode: int = MODE_FILL, per_pixel: bool = False,
                 shader_idx: int = 5, bg_idx: int = 0,
                 show_cm: bool | None = None, backend: str = "auto",
                 raster_queue=None, return_overflow: bool = False):
    """Render one frame -> uint32 ABGR [h, w], bottom-left origin
    (rustexp_tpu/raster/pipeline.py:997).

    Ported: mode=MODE_FILL with backend="queue" and a prebuilt
    `raster_queue` (build_scene_queue). With return_overflow=True returns
    (fb, stale): stale means the cached queue no longer covers this
    frame — rebuild it and render again.
    """
    if show_cm is None:
        show_cm = sh.shader_uses_cm(shader_idx)
    if mode != MODE_FILL:
        raise NotImplementedError(
            f"render mode {MODE_NAMES[mode]} is not ported yet (ROADMAP A10)")
    if backend != "queue" or raster_queue is None:
        raise NotImplementedError(
            f"render_frame(backend={backend!r}) without a prebuilt queue is "
            "not ported yet: the bins path is ROADMAP A9/B2, the XLA "
            "oracle A4")
    sh.shader_fn(shader_idx)  # an unported shader raises before any work
    fb = background(bg_idx, w, h, scene.cp3.device)
    colors = None if per_pixel else vertex_colors(scene, eye, tick, w, h,
                                                  shader_idx)
    fb, stale = raster_and_shade_queue(
        scene, raster_queue, colors, eye, tick, w=w, h=h,
        per_pixel=per_pixel, shader_idx=shader_idx, bg_fb=fb)
    if show_cm:
        fb = overlay_cross(fb, scene.cross)
    fb = fb.view(torch.uint32)
    return (fb, stale) if return_overflow else fb

"""The plain reference renderer: one 512x512 Fill frame of the rasterizer.

Written from the reference's semantics (blitzcode/rust-exp rasterizer.rs,
as tools/ref_oracle/oracle.cpp restates them scalar by scalar): the
vertex transform with the viewport applied before the divide, the 28.4
fixed-point edge functions with the bottom-left fill rule, the strict
less-than depth test over triangles in submission order (so the first of
equal depths wins), perspective-correct interpolation, the CMRefl shader
on point-sampled cube maps, the vertical background gradient, the
cube-map cross overlay and the 11-bit gamma pack.

Plain PyTorch on any device, with no kernel, cache or queue: every
(triangle, pixel-in-its-box) pair is tested at once, in blocks of
triangles, and each pixel keeps the lexicographically least (depth,
triangle) pair, which is what the serial loop leaves behind. Each float
operation is one torch op, in the order the reference writes it, so each
product rounds before the sum that follows. ``dtype`` sets the precision
of every float operation: float32 is the reference; a lower one is the
control that the comparison must refuse. Imports nothing of the program.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import assets

BACKGROUNDS = (
    ((0.3, 0.3, 0.3), (0.7, 0.7, 0.7)),
    ((1.0, 0.4, 0.0), (0.0, 0.5, 0.5)),
    ((1.0, 0.0, 1.0), (1.0, 0.0, 1.0)),
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
)
CMREFL = 5  # the only shader the configurations use
PAIRS_PER_BLOCK = 1 << 22

F = np.float32

try:
    _libm = ctypes.CDLL("libm.so.6")
    _libm.tanf.restype = ctypes.c_float
    _libm.tanf.argtypes = [ctypes.c_float]

    def _tanf(x):
        return F(_libm.tanf(float(x)))
except OSError:  # no glibc: numpy's f32 tan
    def _tanf(x):
        return np.tan(F(x))


# ---------------------------------------------------------------------------
# Host matrices, f32 per operation (rasterizer.rs:131-146, 1180-1259)
# ---------------------------------------------------------------------------


def _m4_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    r = np.zeros((4, 4), F)
    for i in range(4):
        for j in range(4):
            s = a[i, 0] * b[0, j]
            s = s + a[i, 1] * b[1, j]
            s = s + a[i, 2] * b[2, j]
            r[i, j] = s + a[i, 3] * b[3, j]
    return r


def normalize_dimensions(pos: np.ndarray) -> np.ndarray:
    """Mesh -> origin-centred unit cube: scale(1/max extent) @ translate."""
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    c = (lo + hi) * F(0.5)
    ext = hi - lo
    s = F(1.0) / max(ext[0], ext[1], ext[2])
    scale = np.diag(np.array([s, s, s, 1.0], F))
    transl = np.eye(4, dtype=F)
    transl[:3, 3] = -c
    return _m4_mul(scale, transl)


def _normalize3(v):
    n = np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return np.array([v[0] / n, v[1] / n, v[2] / n], F)


def _cross3(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], F)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def world_to_viewport(eye: np.ndarray, w: int, h: int) -> np.ndarray:
    """(viewport @ perspective(45, w/h, 0.1, 10)) @ look_at(eye, 0, +y)."""
    eye = np.asarray(eye, F)
    z = _normalize3(eye - np.zeros(3, F))
    x = _normalize3(_cross3(np.array([0, 1, 0], F), z))
    y = _cross3(z, x)
    ne = -eye
    look = np.array([[x[0], x[1], x[2], _dot3(ne, x)],
                     [y[0], y[1], y[2], _dot3(ne, y)],
                     [z[0], z[1], z[2], _dot3(ne, z)],
                     [0, 0, 0, 1]], F)
    tan_half = _tanf(F(45.0) * F(0.0174532925) / F(2.0))
    near, far = F(0.1), F(10.0)
    persp = np.array(
        [[F(1.0) / (F(w) / F(h) * tan_half), 0, 0, 0],
         [0, F(1.0) / tan_half, 0, 0],
         [0, 0, -(far + near) / (far - near),
          -(F(2.0) * far * near) / (far - near)],
         [0, 0, -1, 0]], F)
    wh, hh = F(w) / F(2.0), F(h) / F(2.0)
    vpm = np.array([[wh, 0, 0, wh], [0, hh, 0, hh], [0, 0, 1, 0],
                    [0, 0, 0, 1]], F)
    return _m4_mul(_m4_mul(vpm, persp), look)


# ---------------------------------------------------------------------------
# Per-op vector helpers on (x, y, z) tuples of tensors
# ---------------------------------------------------------------------------


def _mv(m, v):
    """Row-by-row m @ v, each row summed left to right; m is a host array,
    v a tuple of tensors (missing trailing components are 1)."""
    rows = []
    for i in range(m.shape[0]):
        s = v[0] * float(m[i, 0])
        for k in range(1, m.shape[1]):
            s = s + (v[k] * float(m[i, k]) if k < len(v) else float(m[i, k]))
        rows.append(s)
    return tuple(rows)


def _scale(v, s):
    return tuple(c * s for c in v)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """Rust's `f as i32`: toward zero, saturating, NaN -> 0."""
    x = torch.nan_to_num(x.float(), nan=0.0).clamp(-2147483648.0,
                                                   2147483520.0)
    return x.to(torch.int64)


def _texel(d, cm_w: int = assets.CM_W):
    """Major-axis point-sampled texel of direction d -> flat index into
    a [6, 64, 64] face table (rasterizer.rs:680-713)."""
    dx, dy, dz = d
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    xm = (ax > ay) & (ax > az)
    ym = ~xm & (ay > ax) & (ay > az)
    zm = ~xm & ~ym
    face = torch.where(xm, torch.where(dx > 0, 0, 1),
                       torch.where(ym, torch.where(dy > 0, 2, 3),
                                   torch.where(dz > 0, 4, 5)))
    inv = 1.0 / torch.where(xm, ax, torch.where(ym, ay, az))
    u = torch.where(zm | ym, dx, dz) * inv
    v = torch.where(ym, dz, dy) * inv
    u = (u + 1.0) * 0.5
    v = (v + 1.0) * 0.5
    tx = _trunc_i32(u * float(cm_w)).clamp(0, cm_w - 1)
    ty = _trunc_i32(v * float(cm_w)).clamp(0, cm_w - 1)
    return (face * cm_w + ty) * cm_w + tx


def _cm_refl(p, n, col, eye, cm):
    """CMRefl (rasterizer.rs:985-994): diffuse cos^1 at the normal plus
    Phong-normalized cos^8 and cos^64 at the reflection, times col^2."""
    l = 1.0 / torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    nn = _scale(n, l)
    e = _sub(p, eye)
    d = _dot(nn, e)
    r = _sub(e, tuple((c * d) * 2.0 for c in nn))
    tn, tr = _texel(nn), _texel(r)
    c1, c8, c64 = cm[1][tn], cm[2][tr], cm[3][tr]
    out = []
    for k in range(3):
        s = (c1[:, k] + c8[:, k] * 5.0) + c64[:, k] * 33.0
        out.append(s * (col[k] * col[k]))
    return out


def _pack_gamma(rgb, lut: torch.Tensor) -> torch.Tensor:
    """rgb -> int64 ABGR through the 11-bit table (rasterizer.rs:1347)."""
    idx = [_trunc_i32(c * 2047.0) for c in rgb]

    def chan(i):
        return torch.where(i < 0, 0, torch.where(i > 2047, 255,
                                                 lut[i.clamp(0, 2047)]))

    return chan(idx[0]) | (chan(idx[1]) << 8) | (chan(idx[2]) << 16)


def background(bg: int, w: int, h: int, device) -> torch.Tensor:
    """int64 [h, w]: the vertical gradient, packed without gamma."""
    start, end = (np.array(c, F) for c in BACKGROUNDS[bg])
    rows = []
    for y in range(h):
        pos = F(y) / F(h - 1)
        col = start * (F(1.0) - pos) + end * pos
        c8 = [int(F(min(max(c, F(0.0)), F(1.0))) * F(255.0)) for c in col]
        rows.append(c8[0] | (c8[1] << 8) | (c8[2] << 16))
    return torch.tensor(rows, dtype=torch.int64,
                        device=device)[:, None].expand(h, w).clone()


def rasterize(mesh: assets.Mesh, eye, w: int, h: int, device,
              dtype=torch.float32) -> dict:
    """Transform, set-up and depth race of one frame -> a dict of the
    vertex attributes, each pixel's winning pair (pixel, triangle and
    barycentric weights), and the work counts: triangles that pass the
    cull and have a non-empty box, their (triangle, pixel) box tests, and
    the pixels won."""
    dev = torch.device(device)
    ft = dict(dtype=dtype, device=dev)
    eye_h = np.asarray(eye, F)
    m = world_to_viewport(eye_h, w, h)
    ndim = normalize_dimensions(mesh.positions)
    it33 = np.linalg.inv(ndim.astype(np.float64)).T[:3, :3].astype(F)

    pos = torch.tensor(mesh.positions, **ft)
    nrm = torch.tensor(mesh.normals, **ft)
    col = torch.tensor(mesh.colors, **ft)
    world = _mv(ndim[:3], (pos[:, 0], pos[:, 1], pos[:, 2]))
    clip = _mv(m, world)
    inv_w = 1.0 / clip[3]
    vp = (clip[0] * inv_w, clip[1] * inv_w, clip[2] * inv_w)
    nw = _mv(it33, (nrm[:, 0], nrm[:, 1], nrm[:, 2]))

    tris = torch.tensor(mesh.tris, dtype=torch.int64, device=dev)
    fx = [_trunc_i32(vp[0][tris[:, j]] * 16.0) for j in range(3)]
    fy = [_trunc_i32(vp[1][tris[:, j]] * 16.0) for j in range(3)]
    (x0, x1, x2), (y0, y1, y2) = fx, fy
    a2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    lo_x = (torch.minimum(torch.minimum(x0, x1), x2) + 15) >> 4
    lo_y = (torch.minimum(torch.minimum(y0, y1), y2) + 15) >> 4
    hi_x = ((torch.maximum(torch.maximum(x0, x1), x2) + 15) >> 4).clamp(max=w)
    hi_y = ((torch.maximum(torch.maximum(y0, y1), y2) + 15) >> 4).clamp(max=h)
    lo_x, lo_y = lo_x.clamp(min=0), lo_y.clamp(min=0)
    ok = (a2 > 0) & (hi_x > lo_x) & (hi_y > lo_y)
    tri_ids = torch.nonzero(ok).flatten()

    # edges: e_k = dy * (px << 4) + dx * (py << 4) + c_k (oracle.cpp:1198)
    dy = (y0 - y1, y1 - y2, y2 - y0)
    dx = (x1 - x0, x2 - x1, x0 - x2)
    add = [((d > 0) | ((d == 0) & (e > 0))).long() for d, e in zip(dy, dx)]
    const = (x0 * y1 - y0 * x1 + add[0] + 1, x1 * y2 - y1 * x2 + add[1] + 1,
             x2 * y0 - y2 * x0 + add[2] + 1)

    bw, bh = hi_x - lo_x, hi_y - lo_y
    area = torch.where(ok, bw * bh, 0)
    cand = []  # per block: (pixel, z, triangle, b0, b1, b2)
    start = 0
    csum = torch.cumsum(area[tri_ids], 0)
    while start < tri_ids.numel():
        base = int(csum[start - 1]) if start else 0
        stop = int(torch.searchsorted(csum, base + PAIRS_PER_BLOCK,
                                      right=True))
        stop = max(stop, start + 1)
        t = tri_ids[start:stop]
        n_pairs = area[t]
        tp = torch.repeat_interleave(t, n_pairs)
        first = torch.cumsum(n_pairs, 0) - n_pairs
        local = torch.arange(tp.numel(), device=dev) \
            - torch.repeat_interleave(first, n_pairs)
        px = lo_x[tp] + local % bw[tp]
        py = lo_y[tp] + local // bw[tp]
        e = [dy[k][tp] * (px << 4) + dx[k][tp] * (py << 4) + const[k][tp]
             for k in range(3)]
        inside = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)
        tp, px, py = tp[inside], px[inside], py[inside]
        inv_a2 = 1.0 / a2[tp].to(dtype)
        b = [(e[k][inside] - add[k][tp] - 1).to(dtype) * inv_a2
             for k in range(3)]
        i0, i1, i2 = tris[tp, 0], tris[tp, 1], tris[tp, 2]
        z0 = vp[2][i0]
        z = (z0 + (vp[2][i1] - z0) * b[2]) + (vp[2][i2] - z0) * b[0]
        keep = z < 1.0
        cand.append((py[keep] * w + px[keep], z[keep], tp[keep],
                     *(bk[keep] for bk in b)))
        start = stop
    pix, z, tp, b0, b1, b2 = (torch.cat(c) for c in zip(*cand)) if cand \
        else (torch.zeros(0, dtype=torch.int64, device=dev),) * 6

    n_px = w * h
    zmin = torch.full((n_px,), float("inf"), **ft).scatter_reduce(
        0, pix, z, "amin")
    front = z == zmin[pix]
    tmin = torch.full((n_px,), tris.shape[0], dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, pix[front], tp[front], "amin")
    won = front & (tp == tmin[pix])
    return dict(inv_w=inv_w, world=world, nw=nw, col=col, tris=tris,
                pix=pix[won], tp=tp[won], b=(b0[won], b1[won], b2[won]),
                n_tris=int(tri_ids.numel()), tests=int(area.sum()),
                won=int(won.sum()))


def render(mesh: assets.Mesh, cm: np.ndarray, cross: np.ndarray, eye, *,
           w: int, h: int, per_pixel: bool, shader: int, bg: int,
           show_cm: bool, device, dtype=torch.float32) -> torch.Tensor:
    """One frame -> uint32 ABGR bits as int64 [h, w], row y from the
    bottom, as the reference's framebuffer holds them."""
    if shader != CMREFL or not per_pixel:
        raise ValueError("the reference renders per-pixel CMRefl only")
    dev = torch.device(device)
    ft = dict(dtype=dtype, device=dev)
    eye_h = np.asarray(eye, F)
    r = rasterize(mesh, eye_h, w, h, dev, dtype)
    pix, tp, (b0, b1, b2) = r["pix"], r["tp"], r["b"]
    tris, inv_w, col = r["tris"], r["inv_w"], r["col"]

    i = [tris[tp, j] for j in range(3)]
    iw = [inv_w[ij] for ij in i]
    w_r = 1.0 / ((iw[0] + (iw[1] - iw[0]) * b2) + (iw[2] - iw[0]) * b0)

    def corner(attr, j):
        return tuple(c[i[j]] for c in attr)

    c0, c1, c2 = (corner((col[:, 0], col[:, 1], col[:, 2]), j)
                  for j in range(3))
    c10 = _sub(_scale(c1, iw[1]), _scale(c0, iw[0]))
    c20 = _sub(_scale(c2, iw[2]), _scale(c0, iw[0]))
    c_r = _scale(_add(_add(_scale(c0, iw[0]), _scale(c10, b2)),
                      _scale(c20, b0)), w_r)

    def persp(attr):
        a0, a1, a2_ = (corner(attr, j) for j in range(3))
        s = _add(_add(_scale(_scale(a0, iw[0]), b1),
                      _scale(_scale(a1, iw[1]), b2)),
                 _scale(_scale(a2_, iw[2]), b0))
        return _scale(s, w_r)

    cm_t = torch.tensor(cm.reshape(5, -1, 3), **ft)
    eye_t = tuple(torch.tensor(float(c), **ft) for c in eye_h)
    rgb = _cm_refl(persp(r["world"]), persp(r["nw"]), c_r, eye_t, cm_t)
    lut = torch.tensor(assets.gamma_lut().astype(np.int64), device=dev)
    fb = background(bg, w, h, dev).reshape(-1)
    fb[pix] = _pack_gamma(rgb, lut)
    fb = fb.reshape(h, w)
    if show_cm:
        ch, cw = cross.shape
        x1, y1 = min(10, w), min(10, h)
        x2, y2 = min(x1 + cw, w), min(y1 + ch, h)
        sub = torch.tensor(cross[:y2 - y1, :x2 - x1].astype(np.int64),
                           device=dev)
        fb[y1:y2, x1:x2] = torch.where((sub >> 24) != 0, sub & 0xFFFFFFFF,
                                       fb[y1:y2, x1:x2])
    return fb

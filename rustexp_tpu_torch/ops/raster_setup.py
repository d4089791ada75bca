"""Per-triangle rasterization setup, batched over the whole mesh.

Port of rustexp_tpu/ops/raster_setup.py (TriSetup, TriSetupP with
to_trisetup, setup_triangles_planar for the queue path,
dilate_setup_planar for the amortized moving path, and
setup_triangles/setup_triangles_v for the bins and G-buffer paths):
28.4 fixed-point vertex snap, backface cull via the 2-area cross product,
bottom-left fill-convention biases folded into the edge constants, and
the clipped pixel AABB, with the band renderer's post-snap `y_shift`
(reference rasterizer.rs:1545-1634). int32 arithmetic wraps like
XLA's; the float snap truncates and saturates like XLA's convert.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.colors import trunc_i32


class TriSetup(NamedTuple):
    """Stacked [T, 3] edge equations (rustexp_tpu/ops/raster_setup.py:23).

    Edge i evaluates at pixel (x, y) as ``A[i]*(x<<4) + B[i]*(y<<4) + C[i]``
    in int32; b_i = f32(e_i - bias_i) * inv_a2. Vertex weights
    (v0, v1, v2) <- (b1, b2, b0).
    """

    A: torch.Tensor        # i32 [T, 3]
    B: torch.Tensor        # i32 [T, 3]
    C: torch.Tensor        # i32 [T, 3]
    bias: torch.Tensor     # f32 [T, 3] integer de-bias {1, 2}, f32-encoded
    inv_a2: torch.Tensor   # f32 [T]
    z0: torch.Tensor       # f32 [T]
    z10: torch.Tensor      # f32 [T]
    z20: torch.Tensor      # f32 [T]
    min_x: torch.Tensor    # i32 [T] pixel AABB, [min, max), clipped
    min_y: torch.Tensor    # i32 [T]
    max_x: torch.Tensor    # i32 [T]
    max_y: torch.Tensor    # i32 [T]
    valid: torch.Tensor    # bool [T] front-facing and non-empty AABB


class TriSetupP(NamedTuple):
    """Planar (structure-of-1-D-tensors) setup — the queue-path form
    (rustexp_tpu/ops/raster_setup.py:53). e2 is derived in the kernel from
    e0 + e1 + e2 = S = C0 + C1 + C2.

    ``table`` is None, or the [T + 1, CH] channel table that kernel T
    (ops/raster_queue.py queue_setup_cuda) wrote beside these planes:
    pack_table's of these planes and the attribute columns it holds."""

    A0: torch.Tensor       # i32 [T] edge-0 x-gradient (dy01)
    A1: torch.Tensor       # i32 [T] edge-1 x-gradient (dy12)
    B0: torch.Tensor       # i32 [T] edge-0 y-gradient (dx10)
    B1: torch.Tensor       # i32 [T] edge-1 y-gradient (dx21)
    C0: torch.Tensor       # i32 [T] edge-0 constant (biases folded)
    C1: torch.Tensor       # i32 [T]
    C2: torch.Tensor       # i32 [T]
    A2: torch.Tensor       # i32 [T] edge-2 x-gradient (dy20)
    B2: torch.Tensor       # i32 [T] edge-2 y-gradient (dx02)
    bias0: torch.Tensor    # f32 [T] integer de-bias (e_add + 1), f32-encoded
    bias1: torch.Tensor    # f32 [T]
    bias2: torch.Tensor    # f32 [T]
    inv_a2: torch.Tensor   # f32 [T]
    z0: torch.Tensor       # f32 [T]
    z10: torch.Tensor      # f32 [T]
    z20: torch.Tensor      # f32 [T]
    min_x: torch.Tensor    # i32 [T] pixel AABB, [min, max), clipped
    min_y: torch.Tensor    # i32 [T]
    max_x: torch.Tensor    # i32 [T]
    max_y: torch.Tensor    # i32 [T]
    valid: torch.Tensor    # bool [T]
    table: torch.Tensor | None = None  # f32 [T + 1, CH], kernel T's

    def to_trisetup(self) -> TriSetup:
        """Stacked [T, 3] view (rustexp_tpu/ops/raster_setup.py:86)."""
        return TriSetup(
            A=torch.stack([self.A0, self.A1, self.A2], dim=1),
            B=torch.stack([self.B0, self.B1, self.B2], dim=1),
            C=torch.stack([self.C0, self.C1, self.C2], dim=1),
            bias=torch.stack([self.bias0, self.bias1, self.bias2], dim=1),
            inv_a2=self.inv_a2, z0=self.z0, z10=self.z10, z20=self.z20,
            min_x=self.min_x, min_y=self.min_y,
            max_x=self.max_x, max_y=self.max_y, valid=self.valid,
        )


def setup_triangles_planar(xs, ys, zs, w: int, h: int,
                           y_shift: int = 0) -> TriSetupP:
    """xs/ys/zs f32 [3, T] viewport coordinates per corner -> TriSetupP
    (rustexp_tpu/ops/raster_setup.py:99).

    `y_shift` (pixel rows) translates the frame after the 28.4 snap: the
    band renderer's translation. Subtracting it from the float coordinate
    before the snap would differ, since the snap truncates toward zero
    (a y of 31.97 shifted by 32 rows snaps to 0 locally but to -1 after
    the global snap), so band rasterization stays bit-identical to the
    full frame's rows.
    """
    xi = trunc_i32(xs * 16.0)
    yi = trunc_i32(ys * 16.0)
    if y_shift:
        yi = yi - (int(y_shift) << 4)
    x0, x1, x2 = xi[0], xi[1], xi[2]
    y0, y1, y2 = yi[0], yi[1], yi[2]

    dx10, dy01 = x1 - x0, y0 - y1
    dx21, dy12 = x2 - x1, y1 - y2
    dx02, dy20 = x0 - x2, y2 - y0

    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    front = area2 > 0
    inv_a2 = torch.where(front, 1.0 / area2.clamp(min=1).to(torch.float32),
                         0.0)

    def fill_bias(dy, dx):
        return ((dy > 0) | ((dy == 0) & (dx > 0))).to(torch.int32)

    e0a = fill_bias(dy01, dx10)
    e1a = fill_bias(dy12, dx21)
    e2a = fill_bias(dy20, dx02)

    C0 = x0 * y1 - y0 * x1 + e0a + 1
    C1 = x1 * y2 - y1 * x2 + e1a + 1
    C2 = x2 * y0 - y2 * x0 + e2a + 1

    def min3(a, b, c):
        return torch.minimum(a, torch.minimum(b, c))

    def max3(a, b, c):
        return torch.maximum(a, torch.maximum(b, c))

    min_x = ((min3(x0, x1, x2) + 0xF) >> 4).clamp(min=0)
    min_y = ((min3(y0, y1, y2) + 0xF) >> 4).clamp(min=0)
    max_x = ((max3(x0, x1, x2) + 0xF) >> 4).clamp(max=w)
    max_y = ((max3(y0, y1, y2) + 0xF) >> 4).clamp(max=h)

    valid = front & (max_x > min_x) & (max_y > min_y)
    z0 = zs[0]

    return TriSetupP(
        A0=dy01, A1=dy12, B0=dx10, B1=dx21, C0=C0, C1=C1, C2=C2,
        A2=dy20, B2=dx02,
        bias0=(e0a + 1).to(torch.float32),
        bias1=(e1a + 1).to(torch.float32),
        bias2=(e2a + 1).to(torch.float32),
        inv_a2=inv_a2, z0=z0, z10=zs[1] - z0, z20=zs[2] - z0,
        min_x=min_x, min_y=min_y, max_x=max_x, max_y=max_y, valid=valid,
    )


def setup_triangles(vp, tris, w: int, h: int, y_shift: int = 0) -> TriSetup:
    """vp f32 [V, 4] viewport-space vertices (x, y, z, 1/w), tris i32
    [T, 3] -> stacked TriSetup: the bins path's setup
    (rustexp_tpu/ops/raster_setup.py:206)."""
    tris = tris.long()
    return setup_triangles_v(vp[tris[:, 0]], vp[tris[:, 1]], vp[tris[:, 2]],
                             w, h, y_shift)


def setup_triangles_v(v0, v1, v2, w: int, h: int,
                      y_shift: int = 0) -> TriSetup:
    """Corner-array form: v0/v1/v2 f32 [T, 4] -> TriSetup
    (rustexp_tpu/ops/raster_setup.py:213), with setup_triangles_planar's
    post-snap `y_shift`.

    The same integers as setup_triangles_planar on the same corners, in
    the stacked [T, 3] layout that bin_triangles/bin_pairs pack.
    """
    xs = torch.stack([v0[:, 0], v1[:, 0], v2[:, 0]])
    ys = torch.stack([v0[:, 1], v1[:, 1], v2[:, 1]])
    zs = torch.stack([v0[:, 2], v1[:, 2], v2[:, 2]])
    return setup_triangles_planar(xs, ys, zs, w, h, y_shift).to_trisetup()


def signed_area2(s: TriSetupP) -> torch.Tensor:
    """i32 [T] signed 2*area from the stored channels: the biased
    constants satisfy C0 + C1 + C2 = 2*area + (bias0 + bias1 + bias2), in
    integers (rustexp_tpu/ops/raster_setup.py:193-197)."""
    return (s.C0 + s.C1 + s.C2 - s.bias0.to(torch.int32)
            - s.bias1.to(torch.int32) - s.bias2.to(torch.int32))


def dilate_setup_planar(s: TriSetupP, d: int, w: int, h: int,
                        area_margin: int = 0) -> TriSetupP:
    """Superset setup that the amortized moving path builds its queue from
    (rustexp_tpu/ops/raster_setup.py:167).

    Its coverage contains that of any frame whose camera motion against
    this one moves no vertex by more than `d` px and changes no
    triangle's signed 2*area by more than `area_margin`: each near-front
    triangle's pixel AABB grows by `d` px, and `valid` widens from
    front-facing to 2*area > -area_margin (a pair still back-facing in a
    frame excludes itself: its edge sum is negative, so the sign-OR test
    never passes). Edge equations, z planes and the fill convention are
    untouched, so a frame rendered through a queue built from this setup
    equals one through a fresh queue; check_queue_valid certifies the
    superset at run time.
    """
    near_front = signed_area2(s) > -int(area_margin)
    d = int(d)
    min_x = torch.where(near_front, (s.min_x - d).clamp(min=0), s.min_x)
    min_y = torch.where(near_front, (s.min_y - d).clamp(min=0), s.min_y)
    max_x = torch.where(near_front, (s.max_x + d).clamp(max=w), s.max_x)
    max_y = torch.where(near_front, (s.max_y + d).clamp(max=h), s.max_y)
    return s._replace(
        min_x=min_x, min_y=min_y, max_x=max_x, max_y=max_y,
        valid=near_front & (max_x > min_x) & (max_y > min_y), table=None)

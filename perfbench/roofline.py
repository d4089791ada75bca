"""Published H100 peaks and the least time of a raster call.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM; the pipes' rates
are lanes per SM x 132 SMs x 1.98 GHz (FP32 non-FMA 128 lanes -> 3.35e13
op/s, integer 64 -> 1.67e13, int -> f32 conversion 16 -> 4.18e12). They
assume the card's full 700 W; the run prints the card's power limit.

The work of one raster call is counted from the configuration and the
plain reference's own set-up, never from the program's queue, bins or
launch plan, so it reads the same whatever implements the frame:

* bytes: each triangle that passes the cull with a non-empty box read
  once as its set-up record (three corners of 28.4 x and y, z and 1/w,
  and the per-pixel path's colour and normal, f32 or i32 each: 3 x 10
  words), and each plane of the frame written once: depth, 1/w, colour
  (3) and normal (3), f32 [h, w] each. The world position is left out:
  it follows from the pixel, its depth and 1/w.
* operations: each (triangle, pixel of its box) test, and each pixel won,
  at the per-test and per-pixel counts of the raster's hit loop
  (integer: 3 edge updates, the sign test and its de-biases; FP32: the
  two weights and the depth; two conversions), on the integer, FP32 and
  conversion pipes side by side: the bound is the slowest pipe.
"""

from __future__ import annotations

from .reference import assets, raster

HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
FP32_NON_FMA_OPS_PER_S = 128 * SM_CLOCKS_PER_S
INT_OPS_PER_S = 64 * SM_CLOCKS_PER_S
CONVERT_OPS_PER_S = 16 * SM_CLOCKS_PER_S

INT_PER_TEST, FP_PER_TEST, CVT_PER_TEST = 11, 9, 2
OPS_2MAD, OPS_3W = 4, 5   # FP32 operations per two-MAD / three-weight plane
N2, N3 = 4, 3             # 1/w and colour; normal (per-pixel)
RECORD_WORDS = 3 * 10
PLANES = 1 + N2 + N3      # depth, 1/w, colour, normal


def raster_bound_s(n_tris: int, tests: int, won: int, h: int, w: int
                   ) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of one raster call."""
    t_bytes = (n_tris * RECORD_WORDS * 4 + PLANES * h * w * 4) \
        / HBM_BYTES_PER_S
    t_ops = max((tests * INT_PER_TEST + won) / INT_OPS_PER_S,
                (tests * FP_PER_TEST + won * (1 + OPS_2MAD * N2 + OPS_3W * N3))
                / FP32_NON_FMA_OPS_PER_S,
                (tests * CVT_PER_TEST + won) / CONVERT_OPS_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def raster_bound_ms(cfg: dict, ticks, device) -> float:
    """Mean least ms of one raster call of the configuration `cfg` over
    its camera's eyes at `ticks`, from the plain reference's own set-up."""
    mesh = assets.MESHES[cfg["mesh"]]()
    got = []
    for tick in ticks:
        r = raster.rasterize(mesh, assets.eye(cfg["camera"], tick),
                             cfg["width"], cfg["height"], device)
        got.append(raster_bound_s(r["n_tris"], r["tests"], r["won"],
                                  cfg["height"], cfg["width"])[0])
    return sum(got) / len(got) * 1e3

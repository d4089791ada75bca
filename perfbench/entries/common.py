"""What the entries share: the set-up check that the program loaded the
benchmark's own inputs, and the hooks of an entry that never re-renders.

An entry has `show_cm` (whether its frames carry the cube-map cross),
`frame(tick) -> (uint32 [h, w] frame, a stale flag on the device or
None)`, `start_counting()` / `stop_counting() -> re-renders or None`
around a traced run's counted frames, `close()`, and may have
`raster_launches() -> int`, the raster kernels launched so far, which the
check holds at one or more in every frame."""

from __future__ import annotations

import numpy as np

from perfbench.reference import assets


def check_inputs(cfg: dict, mesh, cm_set) -> None:
    """Raise unless the program's loaded mesh and cube-map set equal the
    configuration's inputs as the benchmark makes them."""
    want = assets.MESHES[cfg["mesh"]]()
    cm, cross = assets.ENVMAPS[cfg["envmap"]]()
    pairs = [(f"mesh {k}", getattr(mesh, k), getattr(want, k))
             for k in ("positions", "normals", "colors", "tris")]
    pairs += [("cube map", cm_set.data, cm), ("cube-map cross", cm_set.cross,
                                              cross)]
    bad = [what for what, got, exp in pairs
           if got.shape != exp.shape or not np.array_equal(got, exp)]
    if bad:
        raise RuntimeError(f"the program loaded other inputs than the "
                           f"benchmark makes: {bad}")


def raster_launches() -> int:
    """Launches of the raster kernels B1 and B2 so far, by the measured
    program's own counters (each kernel's wrapper counts its launches)."""
    from rustexp_tpu_torch.ops import raster_bins, raster_queue

    return (raster_queue.raster_attrs_queue_cuda.launches
            + raster_bins.raster_attrs_bins_cuda.launches)


class NoRerenders:
    """start_counting / stop_counting / close of an entry that never
    renders a frame twice and holds nothing to free."""

    def start_counting(self) -> None:
        pass

    def stop_counting(self):
        return None

    def close(self) -> None:
        pass

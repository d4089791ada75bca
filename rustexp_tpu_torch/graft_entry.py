"""The flagship frame as a callable, and the multi-rank dry run.

Port of the root __graft_entry__.py. ``entry()`` returns (fn,
example_args) for the rasterizer's full frame pipeline (vertex
transform, binned tile rasterization through kernel B2, deferred CMRefl
shading, gamma pack): Cube (mesh 9), 512x512, Fill, per-pixel, shader 5,
render_frame without a structure (the dense bins).

    from rustexp_tpu_torch import graft_entry
    fn, args = graft_entry.entry()        # the card; entry("cpu") on the CPU
    fb = fn(*args)                        # uint32 [512, 512]
    graft_entry.dryrun_multichip(4)       # 4 ranks on the card
"""

from __future__ import annotations

import numpy as np

from .app.multidev import dryrun_multichip
from .assets import cubemap, mesh
from .raster import camera, pipeline as pp
from .runtime import device as pick_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(frame, (scene, eye, tick)) on `device` (the card for None; raises
    without one): frame(scene, eye, tick) renders __graft_entry__.py's
    flagship frame."""
    dev = pick_device(device)
    scene = pp.make_scene(mesh.get_mesh(9), cubemap.get_cm_set(0), dev)
    eye = camera.cam_orbit(0.5)

    def frame(scene, eye, tick):
        return pp.render_frame(
            scene, eye, tick, w=512, h=512, mode=pp.MODE_FILL,
            per_pixel=True, shader_idx=5, bg_idx=0, show_cm=False,
        )

    return frame, (scene, eye, np.float32(0.5))

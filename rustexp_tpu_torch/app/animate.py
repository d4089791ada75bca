"""Offline animation: camera-path turntables.

Port of rustexp_tpu/app/animate.py. Each frame of the mesh's camera path
(ticks tick0 + i / fps) rebuilds the flat queue at its own eye
(transform_corners_planar -> setup_triangles_planar -> build_queue) and
renders through it (kernel B1 on the card): the moving-camera frame of
app/benchmark.py bench_scene_moving, at the frame's own tick. The JAX
package renders the clip as chunked lax.scan dispatches; eager PyTorch
renders frame by frame, so its chunking, tail padding and compile-excluded
first chunk have no counterpart. The static queue caps follow JAX's rule:
the largest queue_stats over every (n / 8)-th eye, choose_shade_w for a
rebuild every frame, suggest_queue_config's margins
(benchmark.moving_caps). Frames the queue's tiles do not fit take the
G-buffer oracle (raster/structure.py), as in JAX.

Reported times include reading every frame back to the host.

Usage:
    python -m rustexp_tpu_torch.app.cli rasterizer --animate 120 --out /tmp/turn
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..assets import cubemap, mesh
from ..core.font import draw_text
from ..core.framebuffer import to_rgb8_topleft, write_png
from ..core.gif import write_gif
from ..raster import camera, pipeline as pp, structure as rs
from ..runtime import device as pick_device
from .benchmark import moving_caps


def render_turntable(mesh_idx: int = 0, shader_idx: int = 5, env_idx: int = 0,
                     bg_idx: int = 0, per_pixel: bool = False,
                     n_frames: int = 60, fps: float = 60.0, w: int = 512,
                     h: int = 512, out_prefix: str = "", overlay: bool = False,
                     tick0: float = 0.0, gif_path: str = "",
                     device: torch.device | str | None = None) -> list:
    """Render n_frames along the mesh's camera path on `device` (the card
    by default); returns each frame's seconds, its read-back included.

    One untimed warm-up frame comes first (the first-use kernel build).
    Frames go to ``<out_prefix>_NNNN.png`` and, with ``gif_path``, into
    one looping GIF at the turntable's fps. Raises RuntimeError when a
    frame overflows the caps sampled over the path.
    """
    dev = pick_device(device)
    scene = pp.make_scene(mesh.get_mesh(mesh_idx),
                          cubemap.get_cm_set(env_idx), dev)
    cam = mesh.mesh_camera(mesh_idx)
    ticks = tick0 + np.arange(n_frames, dtype=np.float64) / fps
    eyes = np.stack([camera.camera_eye(cam, t) for t in ticks]).astype(
        np.float32)
    queued = rs.accepts(rs.QUEUE, w, h)
    caps = moving_caps(scene, eyes, per_pixel, w=w, h=h) if queued else None

    def frame(i: int):
        structure = (rs.queue_at(scene, eyes[i], w, h, caps) if queued
                     else rs.Structure(rs.ORACLE))
        return pp.render_frame(scene, eyes[i], float(np.float32(ticks[i])),
                               w=w, h=h, mode=pp.MODE_FILL,
                               per_pixel=per_pixel, shader_idx=shader_idx,
                               bg_idx=bg_idx, structure=structure,
                               return_overflow=True)

    frame(0)  # warm-up
    times, gif_frames = [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        fb, overflow = frame(i)
        fb = fb.cpu()
        times.append(time.perf_counter() - t0)
        if bool(overflow):
            raise RuntimeError(
                "queue caps overflowed mid-path; re-run (caps are sampled "
                "with margin; a pathological camera path can exceed them)")
        if overlay and (out_prefix or gif_path):
            fb = draw_text(fb, f"frame {i} tick {ticks[i]:.3f}")
        if out_prefix:
            write_png(f"{out_prefix}_{i:04d}.png", to_rgb8_topleft(fb))
        if gif_path:
            gif_frames.append(to_rgb8_topleft(fb))
    if gif_path:
        write_gif(gif_path, gif_frames, fps=fps)
    return times

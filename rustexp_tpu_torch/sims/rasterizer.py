"""Rasterizer experiment: the user-visible driver around raster/pipeline.

Port of rustexp_tpu/sims/rasterizer.py (init/step/render/status,
:78-210) with the same state defaults (per-vertex shading, Fill, mesh 0
Killeroo, shader 5 CMRefl, envmap 0, bg 0; reference
RustRasterizerExperiment.hs:68-75) and the same QUEUE_MIN_TRIS routing.
Meshes under 1,000 triangles take the bins path, not ported yet
(ROADMAP A9/B2). There is no Prewarmer: eager PyTorch has no compile to
hide, and the kernel builds once per checkout.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import torch

from ..assets import cubemap, mesh
from ..core.timing import FrameTimes
from ..raster import camera, pipeline as pp

log = logging.getLogger(__name__)


@dataclass
class RasterState:
    per_pixel: bool = False
    mode: int = pp.MODE_FILL
    mesh_idx: int = 0
    shader_idx: int = 5
    env_idx: int = 0
    bg_idx: int = 0
    backend: str = "auto"
    frame_times: FrameTimes = field(default_factory=FrameTimes)
    _scene_cache: tuple | None = None  # (key, Scene, (kind, queue))


class RasterizerExperiment:
    name = "Rasterizer"

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)

    def init(self, **config) -> RasterState:
        return RasterState(**config)

    def _build(self, scene, eye, w: int, h: int):
        return "queue", pp.build_scene_queue(scene, eye, w, h)

    def _scene(self, state: RasterState, w: int, h: int, eye):
        """Scene + cached raster work structure (rebuilt when stale)."""
        key = (state.mesh_idx, state.env_idx, w, h)
        if state._scene_cache is None or state._scene_cache[0] != key:
            from ..app.benchmark import QUEUE_MIN_TRIS

            m = mesh.get_mesh(state.mesh_idx)
            if m.num_tris < QUEUE_MIN_TRIS:
                raise NotImplementedError(
                    f"mesh {mesh.mesh_name(state.mesh_idx)} has "
                    f"{m.num_tris} triangles (< {QUEUE_MIN_TRIS}): bins "
                    "path, ROADMAP A9/B2")
            scene = pp.make_scene(m, cubemap.get_cm_set(state.env_idx),
                                  self.device)
            state._scene_cache = (key, scene, self._build(scene, eye, w, h))
        return state._scene_cache[1], state._scene_cache[2]

    def step(self, state: RasterState) -> RasterState:
        return state  # all per-frame work happens in render (like the reference)

    @staticmethod
    def _frame_kwargs(state: RasterState, work, w: int, h: int):
        kind, queue = work
        backend = state.backend
        if backend == "auto":
            backend = kind if (w % 128 == 0 and h % 8 == 0) else "xla"
        return dict(w=w, h=h, mode=state.mode, per_pixel=state.per_pixel,
                    shader_idx=state.shader_idx, bg_idx=state.bg_idx,
                    return_overflow=True, backend=backend,
                    raster_queue=queue if backend == "queue" else None)

    def render(self, state: RasterState, w: int, h: int, tick: float = 0.0):
        """One frame -> uint32 ABGR [h, w] on the experiment's device."""
        eye = camera.camera_eye(mesh.mesh_camera(state.mesh_idx), tick)
        scene, work = self._scene(state, w, h, eye)
        t0 = time.perf_counter()
        fb, stale = pp.render_frame(scene, eye, tick,
                                    **self._frame_kwargs(state, work, w, h))
        if bool(stale):
            # The camera left the cached queue's coverage (or it
            # overflowed at build): rebuild at this viewpoint, re-render.
            log.info("raster structure stale at tick %.2f; rebuilding", tick)
            work = self._build(scene, eye, w, h)
            state._scene_cache = (state._scene_cache[0], scene, work)
            fb, stale = pp.render_frame(
                scene, eye, tick, **self._frame_kwargs(state, work, w, h))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        state.frame_times.push(time.perf_counter() - t0)
        return fb

    def status(self, state: RasterState) -> str:
        fps, med, _, _ = state.frame_times.stats()
        m = mesh.get_mesh(state.mesh_idx)
        return (
            f"{fps:.1f}FPS | {med * 1000.0:.2f}ms | Mode: "
            f"{pp.MODE_NAMES[state.mode]} "
            f"| PerPixel: {'On' if state.per_pixel else 'Off'} "
            f"| Mesh: {mesh.mesh_name(state.mesh_idx)} ({m.num_tris} Tri) "
            f"| Shdr: {pp.sh.shader_name(state.shader_idx)} "
            f"| Env: {cubemap.cm_set_name(state.env_idx)} | Bg: {state.bg_idx}"
        )

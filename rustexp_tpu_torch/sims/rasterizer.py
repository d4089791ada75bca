"""Rasterizer experiment: the user-visible driver around raster/pipeline.

Port of rustexp_tpu/sims/rasterizer.py (init/step/render/status,
:78-210) with the same state defaults (per-vertex shading, Fill, mesh 0
Killeroo, shader 5 CMRefl, envmap 0, bg 0; reference
RustRasterizerExperiment.hs:68-75). raster/structure.py routes each
window (the cached flat queue, kernel B1, for meshes of >= 1,000
triangles; the bins at a cached suggest_binning config, kernel B2, for
smaller ones; the G-buffer oracle for windows whose tiles do not fit)
and builds the structure. handle_key is JAX's
wrapping selection keys (reference RustRasterizerExperiment.hs:127-143).
Keys apply at once: eager PyTorch compiles nothing per configuration, so
the JAX package's pending switch has no counterpart (the viewer's
Prewarmer builds the kernel libraries instead, app/viewer.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..assets import cubemap, mesh
from ..core import trace
from ..core.timing import FrameTimes
from ..core.trace import trace_info
from ..raster import camera, pipeline as pp, structure as rs
from ..runtime import device as pick_device


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
    # (key, Scene, raster/structure.py Structure)
    _scene_cache: tuple | None = None


class RasterizerExperiment:
    name = "Rasterizer"

    def __init__(self, device: torch.device | str | None = None):
        self.device = pick_device(device)

    def init(self, **config) -> RasterState:
        return RasterState(**config)

    def _scene(self, state: RasterState, w: int, h: int, eye):
        """Scene + cached raster structure (rebuilt when stale).

        raster/structure.py routes the window (rustexp_tpu/sims/
        rasterizer.py:136) and builds its structure; the key holds the
        route, so a change of ``state.backend`` or of the window builds
        the structure that route needs.
        """
        m = mesh.get_mesh(state.mesh_idx)
        kind = rs.route(m.num_tris, w, h, state.backend)
        key = (state.mesh_idx, state.env_idx, w, h, kind)
        if state._scene_cache is None or state._scene_cache[0] != key:
            scene = pp.make_scene(m, cubemap.get_cm_set(state.env_idx),
                                  self.device)
            state._scene_cache = (key, scene, rs.build(scene, kind, eye, w, h))
        return state._scene_cache[1], state._scene_cache[2]

    def step(self, state: RasterState) -> RasterState:
        return state  # all per-frame work happens in render (like the reference)

    def render(self, state: RasterState, w: int, h: int, tick: float = 0.0):
        """One frame -> uint32 ABGR [h, w] on the experiment's device.

        The whole call is the span ``frame``; a stale frame's rebuild is
        ``experiment.rebuild``, the read of its flag ``sync.read.stale``
        and the closing synchronize ``experiment.sync``."""
        with trace.span("frame"):
            eye = camera.camera_eye(mesh.mesh_camera(state.mesh_idx), tick)
            scene, structure = self._scene(state, w, h, eye)
            kw = dict(w=w, h=h, mode=state.mode, per_pixel=state.per_pixel,
                      shader_idx=state.shader_idx, bg_idx=state.bg_idx,
                      return_overflow=True)
            t0 = time.perf_counter()
            fb, stale = pp.render_frame(scene, eye, tick, structure=structure,
                                        **kw)
            with trace.span("sync.read.stale"):
                stale = bool(stale)
            if stale:
                # The camera left the cached queue's coverage, or the
                # static bins overflowed: rebuild at this viewpoint,
                # re-render.
                trace_info(f"raster structure stale at tick {tick:.2f}; "
                           f"rebuilding")
                with trace.span("experiment.rebuild"):
                    structure = rs.build(scene, structure.kind, eye, w, h)
                state._scene_cache = (state._scene_cache[0], scene, structure)
                fb, stale = pp.render_frame(scene, eye, tick,
                                            structure=structure, **kw)
            if self.device.type == "cuda":
                with trace.span("experiment.sync"):
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

    # key -> (field, step): the field moves by `step` and wraps at its count
    _KEYS = {"M": ("mode", 1), "Q": ("mesh_idx", -1), "W": ("mesh_idx", 1),
             "A": ("shader_idx", -1), "S": ("shader_idx", 1),
             "Z": ("env_idx", -1), "X": ("env_idx", 1),
             "1": ("bg_idx", -1), "2": ("bg_idx", 1)}
    _COUNTS = {"mode": len(pp.MODE_NAMES), "mesh_idx": mesh.NUM_MESHES,
               "shader_idx": pp.sh.NUM_SHADERS,
               "env_idx": cubemap.NUM_CM_SETS,
               "bg_idx": pp.NUM_BACKGROUNDS}

    def handle_key(self, state: RasterState, key: str) -> RasterState:
        """Wrapping scene-selection keys (rustexp_tpu/sims/rasterizer.py:238;
        RustRasterizerExperiment.hs:127-143): M mode, P per-pixel, Q/W
        mesh, A/S shader, Z/X envmap, 1/2 background, B the 12-scene
        benchmark on this experiment's device. Case-insensitive."""
        key = key.upper() if len(key) == 1 else key
        if key in self._KEYS:
            f, step = self._KEYS[key]
            setattr(state, f, (getattr(state, f) + step) % self._COUNTS[f])
        elif key == "P":
            state.per_pixel = not state.per_pixel
        elif key == "B":
            from ..app.benchmark import run_suite

            run_suite(runs=20, device=self.device)
        return state

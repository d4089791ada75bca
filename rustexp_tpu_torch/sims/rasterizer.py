"""Rasterizer experiment: the user-visible driver around raster/pipeline.

Port of rustexp_tpu/sims/rasterizer.py (init/step/render/status,
:78-210) with the same state defaults (per-vertex shading, Fill, mesh 0
Killeroo, shader 5 CMRefl, envmap 0, bg 0; reference
RustRasterizerExperiment.hs:68-75) and the same QUEUE_MIN_TRIS routing:
meshes of >= 1,000 triangles render through a cached flat queue (kernel
B1), smaller ones through the bins at a cached suggest_binning config
(kernel B2), and windows that are not whole 128-px columns and 8-row
strips through the G-buffer oracle (backend "xla"). handle_key is JAX's
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
from ..raster import camera, pipeline as pp
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
    # (key, Scene, work): work is ("queue", Queue) or
    # ("pallas", (cap, spans, rows_cap))
    _scene_cache: tuple | None = None


class RasterizerExperiment:
    name = "Rasterizer"

    def __init__(self, device: torch.device | str | None = None):
        self.device = pick_device(device)

    def init(self, **config) -> RasterState:
        return RasterState(**config)

    @staticmethod
    def _build(scene, eye, w: int, h: int, kind: str):
        if kind == "queue":
            return "queue", pp.build_scene_queue(scene, eye, w, h)
        if kind == "pallas":
            return "pallas", pp.suggest_binning(scene, eye, w, h)
        return "xla", None  # the G-buffer oracle needs no structure

    def _scene(self, state: RasterState, w: int, h: int, eye):
        """Scene + cached raster work structure (rebuilt when stale).

        Big meshes use the flat work queue; small ones the [nT, cap] bins
        (rustexp_tpu/sims/rasterizer.py:136, app/benchmark.py
        QUEUE_MIN_TRIS). A window that renders through the G-buffer
        oracle builds neither: the queue's tiles do not fit it. The key
        holds the resolved route, so a change of ``state.backend`` builds
        the structure that route needs.
        """
        from ..app.benchmark import QUEUE_MIN_TRIS

        m = mesh.get_mesh(state.mesh_idx)
        kind = "queue" if m.num_tris >= QUEUE_MIN_TRIS else "pallas"
        if self._backend(state.backend, kind, w, h) == "xla":
            kind = "xla"
        key = (state.mesh_idx, state.env_idx, w, h, kind)
        if state._scene_cache is None or state._scene_cache[0] != key:
            scene = pp.make_scene(m, cubemap.get_cm_set(state.env_idx),
                                  self.device)
            state._scene_cache = (key, scene,
                                  self._build(scene, eye, w, h, kind))
        return state._scene_cache[1], state._scene_cache[2]

    def step(self, state: RasterState) -> RasterState:
        return state  # all per-frame work happens in render (like the reference)

    @staticmethod
    def _backend(backend: str, kind: str, w: int, h: int) -> str:
        """"auto" -> the structure's kind on windows of whole 128-px
        columns and 8-row strips, else "xla" (rustexp_tpu/sims/
        rasterizer.py:162-164)."""
        if backend == "auto":
            return kind if (w % 128 == 0 and h % 8 == 0) else "xla"
        return backend

    def _frame_kwargs(self, state: RasterState, work, w: int, h: int):
        kind, data = work
        backend = self._backend(state.backend, kind, w, h)
        kw = dict(w=w, h=h, mode=state.mode, per_pixel=state.per_pixel,
                  shader_idx=state.shader_idx, bg_idx=state.bg_idx,
                  return_overflow=True, backend=backend)
        if backend == "queue" and kind == "queue":
            kw["raster_queue"] = data
        elif backend == "pallas" and kind == "pallas":
            kw["raster_cap"], kw["raster_spans"], kw["raster_rows"] = data
        return kw

    def render(self, state: RasterState, w: int, h: int, tick: float = 0.0):
        """One frame -> uint32 ABGR [h, w] on the experiment's device.

        The whole call is the span ``frame``; a stale frame's rebuild is
        ``experiment.rebuild``, the read of its flag ``sync.read.stale``
        and the closing synchronize ``experiment.sync``."""
        with trace.span("frame"):
            eye = camera.camera_eye(mesh.mesh_camera(state.mesh_idx), tick)
            scene, work = self._scene(state, w, h, eye)
            t0 = time.perf_counter()
            fb, stale = pp.render_frame(
                scene, eye, tick, **self._frame_kwargs(state, work, w, h))
            with trace.span("sync.read.stale"):
                stale = bool(stale)
            if stale:
                # The camera left the cached queue's coverage, or the
                # static bins overflowed: rebuild at this viewpoint,
                # re-render.
                trace_info(f"raster structure stale at tick {tick:.2f}; "
                           f"rebuilding")
                with trace.span("experiment.rebuild"):
                    work = self._build(scene, eye, w, h, work[0])
                state._scene_cache = (state._scene_cache[0], scene, work)
                fb, stale = pp.render_frame(
                    scene, eye, tick, **self._frame_kwargs(state, work, w, h))
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

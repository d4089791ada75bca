"""The reference benchmark's frame at its fixed eye: the measured
program's app.benchmark.scene_frame, whose frame() renders one Fill frame
of the scene with its structure (queue or bins) built once in set-up."""

from __future__ import annotations

from perfbench.entries.common import NoRerenders, check_inputs, raster_launches


class Entry(NoRerenders):
    show_cm = False  # scene_frame renders without the cube-map cross
    raster_launches = staticmethod(raster_launches)

    def __init__(self, cfg: dict, traffic: dict, device):
        from rustexp_tpu_torch.app import benchmark as bm

        if traffic["frame_step"] or traffic["start_frames"]:
            raise ValueError("scene_frame renders one fixed eye (tick 0)")
        fixed = (bm.W, bm.H, bm.SHADER, bm.ENV, bm.TICK)
        want = (cfg["width"], cfg["height"], cfg["shader"], cfg["env_idx"],
                0.0)
        if fixed != want or cfg["background"] != 0:
            raise ValueError(f"scene_frame fixes (w, h, shader, env, tick) "
                             f"= {fixed}; the configuration asks {want}")
        self._frame, _, mesh, cm_set = bm.scene_frame(
            cfg["mesh_idx"], cfg["per_pixel"], device)
        check_inputs(cfg, mesh, cm_set)

    def frame(self, tick: float):
        """-> (uint32 frame, the stale or overflow flag on the device)."""
        return self._frame()

    def close(self) -> None:
        self._frame = None

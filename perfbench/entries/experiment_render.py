"""What the viewer drives: the measured program's RasterizerExperiment
.render(state, w, h, tick), which renders through its cached structure,
and on a stale or overflowed one rebuilds it and renders again, then
synchronizes. Re-renders are counted from the Experiment's own trace
line, through a core.trace file sink in the run's TMPDIR."""

from __future__ import annotations

import os
import tempfile

from perfbench.entries.common import check_inputs, raster_launches

STALE_LINE = "raster structure stale"


class Entry:
    show_cm = True  # the Experiment overlays the cross for cube-map shaders
    launches = staticmethod(raster_launches)

    def __init__(self, cfg: dict, traffic: dict, device, seed: int = 0):
        # the scene is the configuration's, whatever the seed
        from rustexp_tpu_torch.assets import cubemap, mesh
        from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

        self.w, self.h = cfg["width"], cfg["height"]
        self.exp = RasterizerExperiment(device)
        self.state = self.exp.init(
            per_pixel=cfg["per_pixel"], mesh_idx=cfg["mesh_idx"],
            shader_idx=cfg["shader"], env_idx=cfg["env_idx"],
            bg_idx=cfg["background"])
        check_inputs(cfg, mesh.get_mesh(cfg["mesh_idx"]),
                     cubemap.get_cm_set(cfg["env_idx"]))
        self._sink = None

    def frame(self, tick: float):
        return self.exp.render(self.state, self.w, self.h, tick), None

    def start_counting(self) -> None:
        from rustexp_tpu_torch.core import trace

        fd, self._sink = tempfile.mkstemp(prefix="perfbench-trace-",
                                          suffix=".log")
        os.close(fd)
        trace.setup(trace.TraceLevel.INFO, self._sink, echo=False,
                    color=False)

    def stop_counting(self) -> int:
        from rustexp_tpu_torch.core import trace

        trace.setup(trace.TraceLevel.WARN, None)
        with open(self._sink) as f:
            n = sum(STALE_LINE in line for line in f)
        os.unlink(self._sink)
        self._sink = None
        return n

    def close(self) -> None:
        self.exp = self.state = None

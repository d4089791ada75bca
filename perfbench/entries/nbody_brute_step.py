"""What the N-body viewer's free-running SimWorker drives with theta
lowered to 0 (app/viewer.py; the a key): the measured program's
NBodyExperiment.step(state), steps back to back, each ending in the
Experiment's own synchronize; the viewer's render thread and its 1 ms
yield are left out. At theta 0 the step is exact all pairs. The state is
drawn from the run's seed by the Experiment's own init. Each frame is one
step, and its output is the state before it and after it: the step binds
new tensors to the state, so no later step overwrites either. The tick is
unused."""

from __future__ import annotations

from perfbench.entries.common import NoRerenders


class Entry(NoRerenders):
    def __init__(self, cfg: dict, traffic: dict, device, seed: int = 0):
        from rustexp_tpu_torch.ops import nbody_pallas
        from rustexp_tpu_torch.sims.nbody import NBodyExperiment

        n, theta = cfg["n"], cfg["theta"]
        self.exp = NBodyExperiment(device)
        route = self.exp.select_backend(n, theta)
        if route != ("brute", None) or n % nbody_pallas.T_TILE:
            raise RuntimeError(
                f"the program routes n={n}, theta={theta} to {route}; the "
                f"configuration needs the brute route through kernel B5, "
                f"which takes n a multiple of {nbody_pallas.T_TILE}")
        self.state = self.exp.init(cfg["mode"], n, cfg["rmin"], cfg["rmax"],
                                   seed, cfg["dt"], theta)
        m = self.state.m
        suns, planets = int((m == 1000.0).sum()), int((m == 1.0).sum())
        if (suns, planets) != (1, n - 1):
            raise RuntimeError(f"masses: {suns} suns of 1000 and {planets} "
                               f"planets of 1; want 1 and {n - 1}")

    @staticmethod
    def launches() -> int:
        """Grid launches of kernel B5, the step's all-pairs forces, so
        far."""
        from rustexp_tpu_torch.ops import nbody_pallas

        return nbody_pallas.forces_pallas_cuda.launches

    def frame(self, tick: float):
        s = self.state
        before = (s.px, s.py, s.vx, s.vy, s.m)
        self.exp.step(s)
        return (before, (s.px, s.py, s.vx, s.vy, s.m)), None

    def close(self) -> None:
        self.exp = self.state = None

"""What the Game of Life viewer's free-running SimWorker drives
(app/viewer.py): the measured program's GoLExperiment.step(state), steps
back to back, each ending in the Experiment's own synchronize; the
viewer's render thread and its 1 ms yield are left out. The grid starts
as the Experiment's own init and is filled at random by the viewer's R
key (handle_key), whose key is split from the run's seed. The R key is
pressed again before every ``reseed_every``-th step (the traffic's),
counted from the first step of set-up, so that every step the check
samples steps a live soup and not settled ash. Each frame is one step,
and its output is the grid before it and after it: the step binds a new
tensor to the state, so no later step overwrites either. The tick is
unused."""

from __future__ import annotations

from perfbench.entries.common import NoRerenders


class Entry(NoRerenders):
    def __init__(self, cfg: dict, traffic: dict, device, seed: int = 0):
        from rustexp_tpu_torch.ops import gol_bits
        from rustexp_tpu_torch.sims.gol import GoLExperiment

        n, k = cfg["n"], cfg["steps_per_frame"]
        if cfg["fill_density"] != 0.5:
            raise RuntimeError(f"the program's R key fills at density 0.5, "
                               f"the configuration states "
                               f"{cfg['fill_density']}")
        self.exp = GoLExperiment(device)
        route = self.exp.route(n, cfg["backend"])
        form = (gol_bits._b4_plan(n // gol_bits.BITS, n, k).form
                if route == "bits" else None)
        if form != "tiled":
            raise RuntimeError(
                f"the program routes a {n}x{n} grid with backend "
                f"{cfg['backend']!r} to {route!r}"
                + (f" in B4's {form} form" if form else "")
                + "; the configuration needs kernel B4 ('bits') in its "
                  "tiled form")
        self.state = self.exp.init(seed=seed, steps_per_frame=k, n=n,
                                   backend=cfg["backend"])
        self.every = traffic["reseed_every"]
        self.steps = 0

    @staticmethod
    def launches() -> int:
        """Grid launches of kernel B4, the step's generations, so far."""
        from rustexp_tpu_torch.ops import gol_bits

        return gol_bits.multi_step_packed_cuda.launches

    def frame(self, tick: float):
        if self.steps % self.every == 0:
            self.exp.handle_key(self.state, "R")
        self.steps += 1
        before = self.state.grid
        self.exp.step(self.state)
        return (before, self.state.grid), None

    def close(self) -> None:
        self.exp = self.state = None

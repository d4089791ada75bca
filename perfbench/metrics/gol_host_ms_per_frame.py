"""gol_host_ms_per_frame: the host ms of the program's `frame` spans
(GoLExperiment.step, sims/gol.py) less those of its closing synchronize,
experiment.sync, over the frames: the host's side of the step, whole
process totals read at the end of the run (rustexp_tpu_torch/core/
trace.py). None where the program has no spans or no frame span ran.
Layer: GoL Experiment. Moves frame_ms."""


def read(t):
    try:
        from rustexp_tpu_torch.core.trace import span_totals
    except ImportError:
        return None
    tot = span_totals()
    frames, ns = tot.get("frame", (0, 0))
    if not frames:
        return None
    return (ns - tot.get("experiment.sync", (0, 0))[1]) / 1e6 / frames

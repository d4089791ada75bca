"""experiment_rerender_pct: frames the Experiment rendered twice (its
span experiment.rebuild: the structure went stale, was rebuilt and the
frame rendered again) over its `frame` spans, whole process totals read
at the end of the run (rustexp_tpu_torch/core/trace.py). None where the
program has no spans or the Experiment never read a stale flag
(sync.read.stale). Layer: Experiment. Moves frame_ms."""


def read(t):
    try:
        from rustexp_tpu_torch.core.trace import span_totals
    except ImportError:
        return None
    tot = span_totals()
    frames = tot.get("frame", (0, 0))[0]
    if not frames or "sync.read.stale" not in tot:
        return None
    return 100.0 * tot.get("experiment.rebuild", (0, 0))[0] / frames

"""stale_rerender_pct: frames the Experiment rendered twice (its structure
went stale, it rebuilt and rendered again) over the frames from the
traced run's sync-debug frames to its end, counted from the Experiment's
own "raster structure stale" trace line. None for an entry that never
re-renders. Layer: Experiment. Moves frame_ms."""


def read(t):
    if t.rerenders is None or not t.frames:
        return None
    return 100.0 * t.rerenders / t.frames

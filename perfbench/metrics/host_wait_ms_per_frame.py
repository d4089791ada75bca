"""host_wait_ms_per_frame: the host ms spent waiting for the card: the
program's sync.* spans (reads of device values, pageable host-to-device
copies) and the Experiment's closing synchronize (experiment.sync;
rustexp_tpu_torch/core/trace.py), over its `frame` spans, whole process
totals read at the end of the run. None where the program has no spans
or no frame span ran. Layer: frame orchestration. Moves frame_ms."""


def read(t):
    try:
        from rustexp_tpu_torch.core.trace import span_totals
    except ImportError:
        return None
    tot = span_totals()
    frames = tot.get("frame", (0, 0))[0]
    if not frames:
        return None
    return sum(ns for name, (_, ns) in tot.items()
               if name.startswith("sync.")
               or name == "experiment.sync") / 1e6 / frames

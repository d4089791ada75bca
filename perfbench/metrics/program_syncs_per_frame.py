"""program_syncs_per_frame: the places the host waited for the card
without an explicit synchronize (the program's sync.* spans: reads of
device values and pageable host-to-device copies, each span one site;
rustexp_tpu_torch/core/trace.py), calls over its `frame` spans, whole
process totals read at the end of the run. None where the program has
no spans or no frame span ran. Layer: frame orchestration. Moves
frame_ms."""


def read(t):
    try:
        from rustexp_tpu_torch.core.trace import span_totals
    except ImportError:
        return None
    tot = span_totals()
    frames = tot.get("frame", (0, 0))[0]
    if not frames:
        return None
    return sum(c for name, (c, _) in tot.items()
               if name.startswith("sync.")) / frames

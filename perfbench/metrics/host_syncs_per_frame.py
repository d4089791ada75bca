"""host_syncs_per_frame: the synchronizing calls (reads of device values)
that torch.cuda.set_sync_debug_mode("warn") flagged in the traced run's
frames under it, per frame. The harness's own synchronize calls lie
outside those frames. Layer: frame orchestration. Moves frame_ms."""


def read(t):
    return t.syncs / t.sync_frames if t.sync_frames else None

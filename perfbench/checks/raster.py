"""The check of a raster configuration: each sampled frame against the
plain reference renderer (perfbench/reference/raster.py) at its tick.

Four numbers, each against the configuration's ``correct_limits``:
``px_off``, the pixels whose 32 bits differ from the reference's in the
worst sampled frame; ``frames_unlike_sample``, where the traffic renders
one fixed eye, the frames whose checksum differs from a sampled frame's;
``stale_frames``, the stale or overflow flags the entry raised; and
``frames_not_rendered``, the frames in which the program launched no
raster kernel, by the entry's ``launches`` hook (a frame returned from a
cache is the right picture at a fixed eye, but no frame rendered). The
entry has to give ``show_cm``, whether its frames carry the cube-map
cross.
"""

from __future__ import annotations

import torch

from perfbench.reference import assets, raster


def check(cell, win, device) -> tuple[dict, int, list[str]]:
    """-> ({name: (value, limit)}, frames that failed, lines for stderr)."""
    cfg = cell.config
    if win.show_cm is None:
        raise ValueError("the raster check needs the entry's show_cm")
    limits = cfg["correct_limits"]
    mesh = assets.MESHES[cfg["mesh"]]()
    cm, cross = assets.ENVMAPS[cfg["envmap"]]()
    out = {}
    worst = 0
    per_frame = []
    kept = sorted(win.sample.kept, key=lambda s: s[0])
    for i, tick, fb in kept:
        ref = raster.render(mesh, cm, cross, assets.eye(cfg["camera"], tick),
                            w=cfg["width"], h=cfg["height"],
                            per_pixel=cfg["per_pixel"], shader=cfg["shader"],
                            bg=cfg["background"], show_cm=win.show_cm,
                            device=device)
        got = fb.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        off = int((got != ref.to(got.device)).sum())
        per_frame.append(off)
        worst = max(worst, off)
    out["px_off"] = (worst, limits["px_off"])
    failed = sum(v > limits["px_off"] for v in per_frame)
    if win.same:
        sums = torch.stack(win.sums).tolist()
        first = win.sample.kept[0][0] - win.first
        out["frames_unlike_sample"] = (
            sum(s != sums[first] for s in sums), limits["frames_unlike_sample"])
    if win.has_flag:
        out["stale_frames"] = (int(win.flags), limits["stale_frames"])
    if win.launches:
        out["frames_not_rendered"] = (win.unlaunched,
                                      limits["frames_not_rendered"])
    failed += sum(out[k][0] for k in ("frames_unlike_sample", "stale_frames",
                                      "frames_not_rendered") if k in out)
    lines = [f"sampled frames {[s[0] for s in kept]}, "
             f"pixels off the reference {per_frame}"]
    return out, failed, lines

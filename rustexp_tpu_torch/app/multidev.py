"""Multi-rank experiment runner: the CLI's ``--devices N`` path.

Port of rustexp_tpu/app/multidev.py (run_multidevice, :47-263) and of
__graft_entry__.dryrun_multichip (:29-200). N ranks are spawned
(parallel/collectives.spawn_ranks) and run the sharded production paths:
GoL halos (parallel/gol_shard.py), block Barnes-Hut with the distributed
sort (parallel/nbody_shard.py), the flat-queue raster bands with a queue
rebuilt every frame (parallel/raster_shard.py) and row-sharded sine. By
default the ranks use the card (every rank on card rank % device_count:
NCCL when each has its own, gloo when they share one); ``--device cpu``
makes them gloo CPU ranks. Rank 0 presents: the status overlay, the PNGs
and the GIF; the parent prints rank 0's lines and each rank's kernel
launches. A rank that fails ends the run with a non-zero exit.

    python -m rustexp_tpu_torch.app.cli gol --devices 4 --frames 4
    python -m rustexp_tpu_torch.app.cli rasterizer --devices 2 --device cpu
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import prng
from ..parallel import collectives as coll

EXPERIMENTS = ("gol", "nbody", "rasterizer", "sine")
RUN_TIMEOUT_S = 1800.0  # every rank of a run must finish within this


def kernel_launches() -> dict:
    """The eight kernel wrappers' launch counts in this process."""
    from ..ops import (gol_bits, gol_stencil, nbody_pallas, raster_bins,
                       raster_queue, sort_bitonic)

    return {"B1": raster_queue.raster_attrs_queue_cuda.launches,
            "B2": raster_bins.raster_attrs_bins_cuda.launches,
            "B3": raster_bins.raster_gbuffer_bins_cuda.launches,
            "B4": gol_bits.multi_step_packed_cuda.launches,
            "B5": nbody_pallas.forces_pallas_cuda.launches,
            "B6": sort_bitonic.sort_kv_cuda.launches,
            "B7": raster_queue.raster_zslot_queue_cuda.launches,
            "B8": gol_stencil.multi_step_pallas_cuda.launches}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sine_band(w: int, h: int, tick, band: int, n_dev: int,
               dev: torch.device) -> torch.Tensor:
    """Rows [band * h/n, (band + 1) * h/n) of sine_frame, int32 bits."""
    from ..sims.sine import _gray_axis

    t = float(np.float32(tick))
    r = h // n_dev
    gx = _gray_axis(w, t, dev)
    gy = _gray_axis(h, t, dev)[band * r:(band + 1) * r]
    gray = (gy[:, None] * gx[None, :] * 255.0).to(torch.int32)
    return gray | (gray << 8) | (gray << 16)


def _run_rank(group, dev, experiment: str, frames: int, size: int, out: str,
              overlay: bool, steps_per_frame: int, grid: int, keys: str,
              gif_path: str) -> dict:
    """One rank of run_multidevice -> {"times", "lines", "launches"}:
    rank 0's lines are what it presented (status lines, files written)."""
    n_dev, rank = coll.world(group)
    w = h = size
    times, lines = [], []
    gif_frames = [] if gif_path and rank == 0 else None

    def present(i, fb, status):
        if rank != 0:
            return
        from ..core.font import draw_text
        from ..core.framebuffer import to_rgb8_topleft, write_png

        if overlay:
            fb = draw_text(fb, status)
        if out or gif_frames is not None:
            rgb = to_rgb8_topleft(fb)
            if out:
                path = f"{out}_{i:03d}.png"
                write_png(path, rgb)
                lines.append(f"wrote {path}")
            if gif_frames is not None:
                gif_frames.append(rgb)
        lines.append(f"[{i}] {status}")

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
        return res

    if experiment == "gol":
        from ..parallel import gol_shard
        from ..sims.gol import GRID_WDH, GoLExperiment, gol_render

        gw = grid or GRID_WDH
        exp = GoLExperiment(dev)
        st = exp.init(n=gw)
        for kk in keys:
            st = exp.handle_key(st, kk)
        if gw % n_dev:
            raise SystemExit(
                f"--grid {gw} doesn't divide over {n_dev} devices; "
                f"pick a grid divisible by the device count")
        rows = gw // n_dev
        # JAX's choice (:119-124): "bits" for grids past the reference's
        # 256 whose shards are whole 32-row words, "pallas" from 32 rows,
        # "roll" for anything that shards
        if rows % 32 == 0 and gw > GRID_WDH:
            backend = "bits"
        elif rows >= 32:
            backend = "pallas"
        else:
            backend = "roll"
        step = gol_shard.make_multi_step(group, k=steps_per_frame,
                                         backend=backend)
        local = gol_shard.shard_grid(st.grid.to(torch.int32), group)
        gens = 0
        for i in range(frames):
            local = timed(lambda: step(local))
            gens += steps_per_frame
            g = coll.all_gather_cat(local, group)
            cells = gw * gw * steps_per_frame / times[-1]
            present(i, gol_render(g, w, h),
                    f"{gw}x{gw} Grid, {gens} Gens, {n_dev} dev [{backend}], "
                    f"{cells:.3g} cells/s")

    elif experiment == "nbody":
        from ..ops.nbody_bh import theta_to_k
        from ..parallel import nbody_shard
        from ..sims.nbody import NBodyExperiment, nbody_render, stable_orbits

        exp = NBodyExperiment(dev)
        if keys:
            # Q/W/E resets, X/x dt, A/a theta, applied to one state first
            st = exp.init()
            for kk in keys:
                st = exp.handle_key(st, kk)
            arrays = (st.px, st.py, st.vx, st.vy, st.m)
            dt_step, theta = float(st.dt), float(st.theta)
        else:
            n0 = 256 * 8 * n_dev   # the default scales with the ranks
            arrays = stable_orbits(prng.key(0), n0, device=dev)
            dt_step, theta = 0.01, 0.85
        n = int(arrays[0].shape[0])
        # the one-rank routing (select_backend), with whole target blocks
        # a rank (:163-166)
        block = next((b for b in NBodyExperiment.BH_BLOCKS
                      if n % b == 0 and (n // b) % n_dev == 0
                      and n // b > 4), None)
        if theta == 0.0 or n < NBodyExperiment.BH_MIN_N or block is None:
            if n % n_dev:
                raise SystemExit(
                    f"--devices {n_dev}: {n} bodies don't shard evenly; "
                    f"pick N divisible by the device count")
            step = nbody_shard.make_step(group)
            label = "brute"
        else:
            B = n // block
            step = nbody_shard.make_step_bh(
                group, block=block, k_near=min(theta_to_k(theta, B), B))
            label = f"bh(th={theta:.2f})"
        state = nbody_shard.shard_particles(arrays, group)
        for i in range(frames):
            state = timed(lambda: step(*state, dt_step))
            px, py, vx, vy = (coll.all_gather_cat(a, group)
                              for a in state[:4])
            dt = times[-1]
            present(i, nbody_render(px, py, vx, vy, w, h),
                    f"{i + 1} Steps, SPS: {1 / dt:.0f}, {dt * 1e3:.2f}ms, "
                    f"{n} Bodies, {n_dev} dev, {label}")

    elif experiment == "rasterizer":
        from ..assets import cubemap, mesh as meshes
        from ..ops.raster_queue import TILE_H
        from ..parallel import raster_shard
        from ..raster import camera, pipeline as pp
        from ..raster.shaders import shader_name
        from ..sims.rasterizer import RasterizerExperiment

        if h % (n_dev * TILE_H):
            raise SystemExit(f"--size {size} not divisible into {n_dev} "
                             f"{TILE_H}-row-tileable bands")
        # the scene through the experiment's keys (Q/W mesh, A/S shader,
        # Z/X envmap, 1/2 background, P per-pixel)
        rexp = RasterizerExperiment(dev)
        rst = rexp.init()
        for kk in keys:
            rst = rexp.handle_key(rst, kk)
        m = meshes.get_mesh(rst.mesh_idx)
        scene = pp.make_scene(m, cubemap.get_cm_set(rst.env_idx), dev)
        cam = meshes.mesh_camera(rst.mesh_idx)
        ticks = [i / 60.0 for i in range(frames)]
        # every rank rebuilds its band's queue every frame, at caps
        # sampled along the camera path; widened once when stale
        cap_eyes = [camera.camera_eye(cam, t)
                    for t in ticks[::max(1, frames // 8)]]

        def make_render(eyes):
            return raster_shard.make_sharded_queue_render_moving(
                group, scene, eyes, w=w, h=h, per_pixel=rst.per_pixel,
                shader_idx=rst.shader_idx, bg_idx=rst.bg_idx)

        render = make_render(cap_eyes)
        for i, tick in enumerate(ticks):
            eye = camera.camera_eye(cam, tick)

            def frame():
                nonlocal render, cap_eyes
                fb, stale = render(scene, eye, tick)
                if bool(stale):
                    cap_eyes = cap_eyes + [eye]
                    render = make_render(cap_eyes)
                    fb, stale = render(scene, eye, tick)
                return fb

            fb = timed(frame)
            dt = times[-1]
            present(i, fb, f"{1 / dt:.1f}FPS {dt * 1e3:.2f}ms | {n_dev} dev "
                           f"| {m.name} | {shader_name(rst.shader_idx)} "
                           f"| {m.num_tris} Tri")

    elif experiment == "sine":
        if h % n_dev:
            raise SystemExit(f"--size {size} not divisible into {n_dev} "
                             f"row bands")
        for i in range(frames):
            band = timed(lambda: _sine_band(w, h, i / 60.0, rank, n_dev, dev))
            fb = coll.all_gather_cat(band, group).view(torch.uint32)
            present(i, fb, f"sine {times[-1] * 1e3:.2f}ms | {n_dev} dev")

    else:
        raise SystemExit(f"--devices does not support experiment "
                         f"{experiment!r}")

    if gif_frames:
        from ..core.gif import write_gif

        write_gif(gif_path, gif_frames, fps=10.0)
        lines.append(f"wrote {gif_path}")
    return {"times": times, "lines": lines, "launches": kernel_launches()}


def run_multidevice(experiment: str, n_dev: int, frames: int, size: int,
                    out: str, overlay: bool = True, steps_per_frame: int = 8,
                    grid: int = 0, keys: str = "", gif_path: str = "",
                    device: torch.device | str = "cuda") -> list:
    """Run `frames` sharded rounds of `experiment` on n_dev spawned ranks
    on `device` -> rank 0's per-frame seconds (:47).

    ``keys`` are the reference keybindings applied to a one-rank state
    before sharding: they select the scene or configuration as in the
    one-rank loop. Prints rank 0's lines (status, files written) and each
    rank's kernel launches.
    """
    if experiment not in EXPERIMENTS:
        raise SystemExit(f"--devices does not support experiment "
                         f"{experiment!r}")
    if n_dev < 1:
        raise SystemExit(f"--devices {n_dev}: need at least one")
    results = coll.spawn_ranks(
        _run_rank, n_dev, torch.device(device), timeout=RUN_TIMEOUT_S,
        args=(experiment, frames, size, out, overlay, steps_per_frame, grid,
              keys, gif_path))
    for line in results[0]["lines"]:
        print(line)
    for rank, r in enumerate(results):
        kept = {k: v for k, v in r["launches"].items() if v}
        print(f"rank {rank} kernel launches: {kept}")
    return results[0]["times"]


# ---------------------------------------------------------------------------
# The dry run (__graft_entry__.dryrun_multichip)
# ---------------------------------------------------------------------------


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _dryrun_rank(group, dev) -> dict:
    """The ten steps of __graft_entry__.dryrun_multichip on this rank, each
    checking the shape (and flags) of what it returns."""
    from ..assets import cubemap, mesh as meshes
    from ..parallel import gol_shard, nbody_shard, raster_shard
    from ..raster import camera, pipeline as pp
    from ..sims.nbody import stable_orbits

    n, rank = coll.world(group)
    done = []

    # 1) row-sharded sine
    w, h = 256, 8 * n
    fb = coll.all_gather_cat(_sine_band(w, h, 0.25, rank, n, dev), group)
    _check(fb.shape == (h, w), "fb shape")
    done.append("sine")

    # 2) GoL with one-row halos
    g = torch.zeros((8 * n, 128), dtype=torch.int32, device=dev)
    g[4, 4:7] = 1
    gout = gol_shard.make_multi_step(group, k=4)(gol_shard.shard_grid(g, group))
    _check(gout.shape == (8, 128), "gout shape")
    done.append("gol roll")

    # 3) brute-force N-body, sources all-gathered
    nb = 16 * n
    arrs = stable_orbits(prng.key(0), nb, device=dev)
    nout = nbody_shard.make_step(group)(
        *nbody_shard.shard_particles(arrs, group), 0.01)
    _check(nout[0].shape == (16,), "nout shape")
    done.append("nbody brute")

    # 4) G-buffer bands, the oracle
    scene = pp.make_scene(meshes.make_cube(), cubemap.make_procedural_set(),
                          dev)
    eye = camera.cam_orbit(0.5)
    fb = raster_shard.render_frame_sharded(
        scene, eye, 0.5, group, w=128, h=16 * n, per_pixel=True, shader_idx=2)
    _check(fb.shape == (16 * n, 128), "fb shape")
    done.append("gbuffer xla")

    # 5) G-buffer bands through B3, the overflow flag checked
    fb2, overflow = raster_shard.render_frame_sharded(
        scene, eye, 0.5, group, w=128, h=32 * n, per_pixel=False,
        shader_idx=2, backend="pallas", return_overflow=True)
    _check(fb2.shape == (32 * n, 128), "fb2 shape")
    _check(not bool(overflow), "triangle bin overflow in sharded raster")
    done.append("gbuffer pallas")

    # 6) flat-queue bands on a cached queue, and 6b) rebuilt every frame
    qh = 16 * n
    caps = raster_shard.band_queue_caps(scene, [eye], w=128, h=qh, n_dev=n,
                                        group=group)
    queue = raster_shard.build_band_queue(scene, eye, caps, w=128, h=qh,
                                          n_dev=n, band=rank)
    fb3, stale = raster_shard.make_sharded_queue_render(
        group, scene, eye, w=128, h=qh, per_pixel=True, shader_idx=5)(
            scene, queue, eye, 0.5)
    _check(fb3.shape == (qh, 128), "fb3 shape")
    _check(not bool(stale), "stale queue in sharded flat-queue raster")
    mv_eyes = [camera.cam_orbit(t) for t in (0.3, 0.5)]
    fb3m, stale_m = raster_shard.make_sharded_queue_render_moving(
        group, scene, mv_eyes, w=128, h=qh, per_pixel=True, shader_idx=5)(
            scene, mv_eyes[0], 0.3)
    _check(fb3m.shape == (qh, 128), "fb3m shape")
    _check(not bool(stale_m), "caps stale in sharded moving-camera raster")
    done.append("queue bands")

    # 7) block Barnes-Hut, target blocks sharded
    arrs = stable_orbits(prng.key(1), 32 * 8 * n, device=dev)
    bout = nbody_shard.make_step_bh(group, block=32, k_near=6)(
        *nbody_shard.shard_particles(arrs, group), 0.01)
    _check(bout[0].shape == (32 * 8,), "bout shape")
    done.append("nbody bh")

    # 8) GoL through the fused stencil with k-row halos
    gp = torch.zeros((16 * n, 128), dtype=torch.int32, device=dev)
    gp[8, 4:7] = 1
    gpout = gol_shard.make_multi_step(group, k=4, backend="pallas")(
        gol_shard.shard_grid(gp, group))
    _check(gpout.shape == (16, 128), "gpout shape")
    done.append("gol pallas")

    # 9) GoL through the SWAR kernel, the halo rounded to 16 rows
    gb = torch.zeros((32 * n, 128), dtype=torch.int32, device=dev)
    gb[8, 4:7] = 1
    gbout = gol_shard.make_multi_step(group, k=4, backend="bits")(
        gol_shard.shard_grid(gb, group))
    _check(gbout.shape == (32, 128), "gbout shape")
    done.append("gol bits")

    # 10) JAX's ("dcn", "ici") mesh: one combined axis, here the group of
    # all ranks: GoL, brute N-body and the G-buffer bands over it
    if n % 2 == 0:
        g2 = torch.zeros((8 * n, 128), dtype=torch.int32, device=dev)
        g2[5, 4:7] = 1
        g2out = gol_shard.make_multi_step(group, k=4)(
            gol_shard.shard_grid(g2, group))
        _check(g2out.shape == (8, 128), "g2out shape")
        arrs = stable_orbits(prng.key(0), nb, device=dev)
        n2out = nbody_shard.make_step(group)(
            *nbody_shard.shard_particles(arrs, group), 0.01)
        _check(n2out[0].shape == (16,), "n2out shape")
        fb4 = raster_shard.make_sharded_render(
            group, w=128, h=16 * n, shader_idx=2)(scene, eye, 0.5)
        _check(fb4.shape == (16 * n, 128), "fb4 shape")
        done.append("combined axis")
    _sync(dev)
    return {"steps": done, "launches": kernel_launches()}


def dryrun_multichip(n_devices: int,
                     device: torch.device | str = "cuda") -> list:
    """Spawn n_devices ranks on `device` and run one tiny step of every
    sharded path (__graft_entry__.dryrun_multichip's ten steps; step 10's
    two-axis mesh is the group of all ranks) -> each rank's
    {"steps", "launches"}. Raises if any rank fails."""
    return coll.spawn_ranks(_dryrun_rank, n_devices, torch.device(device))

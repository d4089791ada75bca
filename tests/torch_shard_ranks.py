"""Rank bodies of the spawned sharded-path tests.

Imports torch and the port only, never jax, so each spawned rank starts
without it. A body runs on every rank of a gloo group through
rustexp_tpu_torch.parallel.collectives.spawn_ranks, takes numpy inputs
made by the test from a seed, and returns this rank's shards as numpy
arrays; the test concatenates them and holds them against JAX and the
one-rank port.
"""

import numpy as np
import torch

from rustexp_tpu_torch.assets import cubemap, mesh as meshes
from rustexp_tpu_torch.parallel import (gol_shard, nbody_shard, raster_shard,
                                        sort_shard)
from rustexp_tpu_torch.raster import pipeline as pp

torch.set_num_threads(2)  # several ranks share the test machine's cores


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def sims(group, dev, inp: dict) -> dict:
    """GoL in its three bodies, the distributed sort at two chunk sizes,
    block BH (distributed and replicated sort, two steps) and the brute
    step, each on this rank's shard."""
    out = {}
    grid = torch.from_numpy(inp["grid"]).to(dev)
    local = gol_shard.shard_grid(grid, group)
    for backend, k in inp["gol"]:
        step = gol_shard.make_multi_step(group, k=k, backend=backend)
        out[f"gol_{backend}"] = _np(step(local))

    for name in ("sort_pow2", "sort_odd"):
        key, *vals = (torch.from_numpy(a).to(dev) for a in inp[name])
        key, *vals = nbody_shard.shard_particles([key, *vals], group)
        sk, sg, sv = sort_shard.dist_sort_stable(key, vals, group)
        out[name] = [_np(sk), _np(sg)] + [_np(v) for v in sv]

    arrs = nbody_shard.shard_particles(
        [torch.from_numpy(a).to(dev) for a in inp["bh"]], group)
    for dist_sort in (True, False):
        step = nbody_shard.make_step_bh(group, block=inp["block"],
                                        k_near=inp["k_near"],
                                        distributed_sort=dist_sort)
        st = arrs
        for i in range(inp["bh_steps"]):
            st = step(*st, 0.01)
            out[f"bh_{dist_sort}_{i}"] = [_np(a) for a in st]

    arrs = nbody_shard.shard_particles(
        [torch.from_numpy(a).to(dev) for a in inp["brute"]], group)
    out["brute"] = [_np(a) for a in nbody_shard.make_step(group)(*arrs, 0.01)]
    return out


def raster(group, dev, inp: dict) -> dict:
    """The flat-queue band path in both layouts, V and P: the cached-queue
    renderer on this rank's own queue and the moving renderer; every rank
    returns the gathered frames."""
    w, h = inp["w"], inp["h"]
    scene = pp.make_scene(meshes.make_sphere(*inp["sphere"]),
                          cubemap.make_procedural_set(), dev)
    eye = torch.from_numpy(inp["eye"])
    n_dev, rank = group.size(), group.rank()
    out = {}
    for layout in raster_shard.LAYOUTS:
        caps = raster_shard.band_queue_caps(scene, [eye], w=w, h=h,
                                            n_dev=n_dev, layout=layout,
                                            group=group)
        queue = raster_shard.build_band_queue(scene, eye, caps, w=w, h=h,
                                              n_dev=n_dev, band=rank,
                                              layout=layout)
        out[f"caps_{layout}"] = np.asarray(caps)
        for per_pixel in (False, True):
            tag = f"{layout}_{'P' if per_pixel else 'V'}"
            render = raster_shard.make_sharded_queue_render(
                group, scene, eye, w=w, h=h, per_pixel=per_pixel,
                shader_idx=5, layout=layout)
            fb, stale = render(scene, queue, eye, inp["tick"])
            out[f"queue_{tag}"] = _np(fb.view(torch.int32))
            out[f"stale_{tag}"] = bool(stale)
            moving = raster_shard.make_sharded_queue_render_moving(
                group, scene, [torch.from_numpy(e) for e in inp["cap_eyes"]],
                w=w, h=h, per_pixel=per_pixel, shader_idx=5, layout=layout)
            fb, stale = moving(scene, eye, inp["tick"])
            out[f"moving_{tag}"] = _np(fb.view(torch.int32))
            out[f"moving_stale_{tag}"] = bool(stale)
    return out

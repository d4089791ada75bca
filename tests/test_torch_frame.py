"""PyTorch port vs the JAX package: the whole flat-queue frame and the
rasterizer experiment, per-vertex (V) and per-pixel (P), shader 5.

Tolerance: at most 0.3% differing pixels, the repo's golden bound
(tests/test_golden.py). The only stage where the two may round
differently is an unsealed JAX chain that XLA:CPU contracts into an FMA —
the ray_world unprojection (rustexp_tpu/raster/pipeline.py:749-751) and
inv_world_to_vp's ``@``. Measured on this suite's scenes: 0 pixels
(ROADMAP C).
"""

import logging

import numpy as np
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.sims.rasterizer import RasterizerExperiment as JaxExperiment
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.app import benchmark as tbench
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.ops import raster_queue as trq
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

W = H = 128
CPU = torch.device("cpu")
GOLDEN_FRAC = 0.003


def _diff(a, b) -> int:
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint32
    return int((a != b).sum())


@pytest.fixture(scope="module")
def sphere():
    m = jmesh.make_sphere(16, 32)
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))


@pytest.mark.parametrize("per_pixel", [False, True])
def test_render_frame_matches_jax(sphere, per_pixel):
    """Each package builds its own queue (JAX: its "auto" order; the port:
    "tri") and renders; then the port renders the JAX queue (interop)."""
    sj, st = sphere
    eye = camera.cam_orbit(0.7)
    kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=5, backend="queue")
    qj = jpp.build_scene_queue(sj, eye, W, H, per_pixel=per_pixel)
    want = jpp.render_frame(sj, eye, 0.7, raster_queue=qj, **kw)
    qt = tpp.build_scene_queue(st, eye, W, H, per_pixel=per_pixel)
    got, stale = tpp.render_frame(st, eye, 0.7, raster_queue=qt,
                                  return_overflow=True, **kw)
    assert not bool(stale)
    assert _diff(want, got) <= GOLDEN_FRAC * W * H
    carried = interop.queue_from_numpy(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields})
    assert _diff(want, tpp.render_frame(st, eye, 0.7, raster_queue=carried,
                                        **kw)) <= GOLDEN_FRAC * W * H
    bg = np.asarray(jpp.background(0, W, H))
    assert (np.asarray(want) != bg).sum() > W * H // 10  # the sphere is drawn


def test_interop_scene_matches_make_scene(sphere):
    sj, st = sphere
    carried = interop.scene_from_numpy(
        {f: np.asarray(getattr(sj, f)) for f in sj._fields})
    for f in st._fields:
        assert torch.equal(getattr(carried, f), getattr(st, f)), f


@pytest.mark.parametrize("per_pixel", [False, True])
def test_experiment_render_matches_jax(per_pixel):
    """Procedural Killeroo (2,304 triangles, the queue path) through both
    experiments at two ticks; the second reuses the cached queue."""
    je, te = JaxExperiment(), RasterizerExperiment(CPU)
    js, ts = je.init(per_pixel=per_pixel), te.init(per_pixel=per_pixel)
    for tick in (0.0, 0.05):
        want = je.render(js, W, H, tick)
        got = te.render(ts, W, H, tick)
        assert _diff(want, got) <= GOLDEN_FRAC * W * H
    assert ts._scene_cache[2][0] == "queue"
    assert te.status(ts).split("| ", 2)[2] == je.status(js).split("| ", 2)[2]


def test_experiment_rebuilds_stale_queue(caplog):
    """A tick far from the one the queue was built at makes it stale: the
    experiment logs, rebuilds, and renders what a fresh state renders."""
    te = RasterizerExperiment(CPU)
    ts = te.init(per_pixel=True)
    te.render(ts, W, H, 0.0)
    built = ts._scene_cache[2][1]
    with caplog.at_level(logging.INFO, logger="rustexp_tpu_torch"):
        got = te.render(ts, W, H, 3.0)
    assert "stale at tick 3.00" in caplog.text
    assert ts._scene_cache[2][1] is not built
    fresh = te.render(te.init(per_pixel=True), W, H, 3.0)
    assert torch.equal(got, fresh)


def test_bins_path_and_cpu_timing_refused():
    te = RasterizerExperiment(CPU)
    with pytest.raises(NotImplementedError, match="A9/B2"):
        te.render(te.init(mesh_idx=9), W, H, 0.0)  # Cube: 12 triangles
    with pytest.raises(ValueError, match="times the card"):
        tbench.bench_scene(0, True, 1, CPU)
    assert sum(s[3] for s in tbench.SCENES) == tbench.REF_TOTAL_US == 27286
    with pytest.raises(ValueError, match="CUDA"):
        trq.raster_attrs_queue_cuda(
            torch.zeros((1, 5), dtype=torch.int32),
            torch.zeros((1, 12, trq.CHUNK), dtype=torch.int32),
            torch.zeros((1, 10, trq.CHUNK)), 1, 0, 16, W)


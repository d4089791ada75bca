"""PyTorch port vs the JAX package: the whole flat-queue frame and the
rasterizer experiment, per-vertex (V) and per-pixel (P), shader 5.

Tolerance: at most 0.3% differing pixels, the repo's golden bound
(tests/test_golden.py). The only stage where the two may round
differently is an unsealed JAX chain that XLA:CPU contracts into an FMA —
the ray_world unprojection (rustexp_tpu/raster/pipeline.py:749-751) and
inv_world_to_vp's ``@``. Measured on this suite's scenes: 0 pixels
(ROADMAP C).
"""

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
from rustexp_tpu_torch.core import trace
from rustexp_tpu_torch.ops import raster_bins as trb
from rustexp_tpu_torch.ops import raster_queue as trq
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import structure as tstruct
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
    """Each package builds its own queue (both with their "auto" order)
    and renders; then the port renders the JAX queue (interop)."""
    sj, st = sphere
    eye = camera.cam_orbit(0.7)
    kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=5)
    qj = jpp.build_scene_queue(sj, eye, W, H, per_pixel=per_pixel)
    want = jpp.render_frame(sj, eye, 0.7, backend="queue", raster_queue=qj,
                            **kw)
    qt = tstruct.build(st, tstruct.QUEUE, eye, W, H, per_pixel=per_pixel)
    got, stale = tpp.render_frame(st, eye, 0.7, structure=qt,
                                  return_overflow=True, **kw)
    assert not bool(stale)
    assert _diff(want, got) <= GOLDEN_FRAC * W * H
    carried = interop.queue_from_numpy(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, CPU)
    assert _diff(want, tpp.render_frame(
        st, eye, 0.7, structure=tstruct.Structure(tstruct.QUEUE, carried),
        **kw)) <= GOLDEN_FRAC * W * H
    bg = np.asarray(jpp.background(0, W, H))
    assert (np.asarray(want) != bg).sum() > W * H // 10  # the sphere is drawn


def test_interop_scene_matches_make_scene(sphere):
    sj, st = sphere
    carried = interop.scene_from_numpy(
        {f: np.asarray(getattr(sj, f)) for f in sj._fields}, CPU)
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


def test_experiment_rebuilds_stale_queue(tmp_path):
    """A tick far from the one the queue was built at makes it stale: the
    experiment traces it (core.trace, INFO), rebuilds, and renders what a
    fresh state renders."""
    te = RasterizerExperiment(CPU)
    ts = te.init(per_pixel=True)
    te.render(ts, W, H, 0.0)
    built = ts._scene_cache[2][1]
    log = tmp_path / "trace.log"
    trace.setup(level=trace.TraceLevel.INFO, file_path=str(log), echo=False)
    try:
        got = te.render(ts, W, H, 3.0)
    finally:
        trace.setup(level=trace.TraceLevel.WARN, file_path=None, echo=True)
    assert "stale at tick 3.00" in log.read_text()
    assert ts._scene_cache[2][1] is not built
    fresh = te.render(te.init(per_pixel=True), W, H, 3.0)
    assert torch.equal(got, fresh)


def test_experiment_rebuilds_on_backend_switch():
    """A state that rendered through the oracle (backend "xla") and then
    switches to "auto" builds the queue its route needs; the frames are
    equal."""
    te = RasterizerExperiment(CPU)
    ts = te.init(per_pixel=True, backend="xla")
    oracle = te.render(ts, W, H, 0.0)
    assert ts._scene_cache[2] == ("xla", None)
    ts.backend = "auto"
    queued = te.render(ts, W, H, 0.0)
    assert ts._scene_cache[2][0] == "queue"
    assert torch.equal(oracle, queued)


def test_bins_path_and_cpu_timing_refused():
    """The bins path runs (Cube, 12 triangles, takes it), and so does a
    window of partial tiles, through the G-buffer oracle; what is still
    refused: timing on the CPU, and a kernel wrapper given CPU tensors."""
    te = RasterizerExperiment(CPU)
    st = te.init(mesh_idx=9)
    assert te.render(st, W, H, 0.0).shape == (H, W)
    assert st._scene_cache[2][0] == "pallas"
    fb = te.render(st, 120, H, 0.0)
    assert st._scene_cache[2] == ("xla", None)
    assert torch.equal(fb, tpp.render_frame(
        st._scene_cache[1], camera.camera_eye(jmesh.mesh_camera(9), 0.0),
        0.0, w=120, h=H, structure=tstruct.Structure(tstruct.ORACLE)))
    for mesh_idx in (0, 9):
        with pytest.raises(ValueError, match="times the card"):
            tbench.bench_scene(mesh_idx, True, 1, device=CPU)
    with pytest.raises(ValueError, match="times the card"):
        tbench.run_suite(1, device=CPU)
    assert sum(s[3] for s in tbench.SCENES) == tbench.REF_TOTAL_US == 27286
    with pytest.raises(ValueError, match="CUDA"):
        trq.raster_attrs_queue_cuda(
            torch.zeros((1, 5), dtype=torch.int32),
            torch.zeros((1, 12, trq.CHUNK), dtype=torch.int32),
            torch.zeros((1, 10, trq.CHUNK)), 1, 0, 16, W)
    with pytest.raises(ValueError, match="CUDA"):
        trb.raster_attrs_bins_cuda(
            torch.zeros((4,), dtype=torch.int32),
            torch.zeros((4, 8, 12), dtype=torch.int32),
            torch.zeros((4, 8, 19)), 4, 0, H, W)
    with pytest.raises(ValueError, match="CUDA"):
        trb.raster_gbuffer_bins_cuda(
            torch.zeros((4,), dtype=torch.int32),
            torch.zeros((4, 8, 12), dtype=torch.int32),
            torch.zeros((4, 8, 7)), H, W)
    with pytest.raises(ValueError, match="CUDA"):
        trq.raster_zslot_queue_cuda(
            torch.zeros((1, 5), dtype=torch.int32),
            torch.zeros((1, 12, trq.CHUNK), dtype=torch.int32),
            torch.zeros((1, 10, trq.CHUNK)), 16, W)


SPHERE, CUBE = 2304, 12  # the stand-ins' triangle counts (meshes 0 and 9)


@pytest.mark.parametrize("n_tris,w,h,backend,kind", [
    (SPHERE, 512, 512, "auto", "queue"),
    (CUBE, 512, 512, "auto", "pallas"),
    (SPHERE, 192, 192, "auto", "xla"),
    (CUBE, 192, 192, "auto", "xla"),
    (SPHERE, 256, 136, "auto", "xla"),
    (CUBE, 256, 136, "auto", "xla"),
    (SPHERE, 256, 144, "auto", "queue"),
    (CUBE, 256, 144, "auto", "xla"),
    (SPHERE, 1280, 720, "auto", "queue"),
    (CUBE, 1280, 720, "auto", "xla"),
    (tstruct.QUEUE_MIN_TRIS - 1, 512, 512, "auto", "pallas"),
    (tstruct.QUEUE_MIN_TRIS, 512, 512, "auto", "queue"),
    (CUBE, 512, 512, "queue", "queue"),
    (SPHERE, 512, 512, "pallas", "pallas"),
    (SPHERE, 512, 512, "xla", "xla"),
    (SPHERE, 96, 80, "queue", "xla"),
    (CUBE, 256, 144, "pallas", "xla"),
])
def test_route_table(n_tris, w, h, backend, kind):
    """One rule picks the structure: "auto" by triangle count, then the
    oracle wherever that structure's tiles (16x128 queue, 32x128 bins)
    do not divide the frame. 512^2 sphere -> queue, 512^2 Cube -> bins
    and the viewer's 192^2 -> oracle, as before; 256x136, 256x144 and
    1280x720 crashed the Experiment before (ROADMAP C7)."""
    assert tstruct.route(n_tris, w, h, backend) == kind


@pytest.mark.parametrize("mesh_idx,w,h", [(0, 256, 136), (9, 256, 144)])
def test_experiment_renders_windows_its_structure_rejects(mesh_idx, w, h):
    """Windows whose rows the auto structure's tiles do not divide (the
    queue's 16 for mesh 0 at 136 rows, the bins' 32 for the Cube at 144)
    raised before (ROADMAP C7); they now render through the oracle, bit
    for bit render_frame's oracle frame at the same eye, in V and P."""
    te = RasterizerExperiment(CPU)
    eye = camera.camera_eye(jmesh.mesh_camera(mesh_idx), 0.0)
    for per_pixel in (False, True):
        ts = te.init(mesh_idx=mesh_idx, per_pixel=per_pixel)
        got = te.render(ts, w, h, 0.0)
        assert ts._scene_cache[2] == (tstruct.ORACLE, None)
        want = tpp.render_frame(ts._scene_cache[1], eye, 0.0, w=w, h=h,
                                per_pixel=per_pixel,
                                structure=tstruct.Structure(tstruct.ORACLE))
        assert torch.equal(got, want)

"""Kernels B1 and B2 on the card: each CUDA kernel against its plain
PyTorch version, and whole frames on the card (queue and bins paths)
against the same frames on the CPU.

These tests need a CUDA device and skip without one. This file imports no
jax (the card's machine has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from rustexp_tpu_torch.assets import cubemap, mesh
from rustexp_tpu_torch.ops import raster_bins as rb
from rustexp_tpu_torch.ops import raster_queue as rq
from rustexp_tpu_torch.ops.raster_setup import setup_triangles
from rustexp_tpu_torch.raster import camera, pipeline as pp

W = H = 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,per_pixel",
                         [(0, False), (0, True), (6, False), (6, True)])
def test_b1_kernel_matches_plain_on_card(mesh_idx, per_pixel):
    """Bit-equal z, slot and planes under the mask, at the main path's
    512x512 shapes (procedural Killeroo and TorusKnot)."""
    dev = _card()
    scene = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0), dev)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), 0.0)
    queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H, 5)
    setup, extra, n2, n3 = pp.queue_attr_channels(scene, colors, eye, W, H,
                                                  per_pixel=per_pixel)
    rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
    args = (queue.scal, rows_i, rows_f, n2, n3, H, W)
    launches = rq.raster_attrs_queue_cuda.launches
    zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
    assert rq.raster_attrs_queue_cuda.launches == launches + 1
    zp, sp, lp = rq.raster_attrs_queue_plain(*args)
    mask = sp >= 0
    assert torch.equal(sk, sp) and mask.any()
    assert torch.equal(zk[mask].view(torch.int32), zp[mask].view(torch.int32))
    assert torch.equal(lk[:, mask].view(torch.int32),
                       lp[:, mask].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("per_pixel", [False, True])
def test_frame_on_card_matches_cpu(per_pixel):
    dev = _card()
    frames = []
    for d in (dev, torch.device("cpu")):
        scene = pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), d)
        eye = camera.camera_eye(mesh.mesh_camera(0), 0.0)
        queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
        frames.append(pp.render_frame(
            scene, eye, 0.0, w=W, h=H, per_pixel=per_pixel, backend="queue",
            raster_queue=queue).cpu().view(torch.int32))
    assert int((frames[0] != frames[1]).sum()) <= 0.003 * W * H


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,per_pixel,binning",
                         [(9, False, "suite"), (9, True, "suite"),
                          (6, True, "default")])
def test_b2_kernel_matches_plain_on_card(mesh_idx, per_pixel, binning):
    """Bit-equal z, slot and planes over the whole frame at 512x512: the
    Cube at suggest_binning's cap and spans (the suite's shapes), the
    procedural TorusKnot at backend="pallas"'s default bins."""
    dev = _card()
    scene = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0), dev)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), 0.0)
    cap = spans = None
    if binning == "suite":
        cap, spans, _ = pp.suggest_binning(scene, eye, W, H)
    vp, world, n_world = pp.transform_vertices(scene, eye, W, H)
    colors = scene.colors if per_pixel else pp.vertex_colors(scene, eye, 0.0,
                                                             W, H, 5)
    extra, n2, n3 = pp.bins_attr_channels(scene, vp, world, n_world, colors,
                                          per_pixel=per_pixel)
    bins = rb.make_bins(setup_triangles(vp, scene.tris, W, H), extra, n2, n3,
                        H, W, cap=cap, spans=spans)
    assert not bool(bins.overflow)
    args = (bins.counts, bins.setup_i, bins.setup_f, n2, n3, H, W)
    launches = rb.raster_attrs_bins_cuda.launches
    zk, sk, lk = rb.raster_attrs_bins_cuda(*args)
    assert rb.raster_attrs_bins_cuda.launches == launches + 1
    zp, sp, lp = rb.raster_attrs_bins_plain(*args)
    assert (sp >= 0).any()
    assert torch.equal(sk, sp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(lk.view(torch.int32), lp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("per_pixel", [False, True])
def test_bins_frame_on_card_matches_cpu(per_pixel):
    """The Cube through the Experiment's bins route, card vs CPU."""
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

    dev = _card()
    frames = []
    for d in (dev, torch.device("cpu")):
        exp = RasterizerExperiment(d)
        st = exp.init(mesh_idx=9, per_pixel=per_pixel)
        frames.append(exp.render(st, W, H, 0.05).cpu().view(torch.int32))
        assert st._scene_cache[2][0] == "pallas"
    assert int((frames[0] != frames[1]).sum()) <= 0.003 * W * H


@pytest.mark.cuda
def test_compacted_bins_frame_on_card_matches_cpu():
    """TorusKnotP through backend="pallas" at suggest_binning's config,
    whose rows_cap takes the compacted shade (the static-size nonzero of
    the occupied blocks), card vs CPU."""
    dev = _card()
    frames = []
    for d in (dev, torch.device("cpu")):
        scene = pp.make_scene(mesh.get_mesh(6), cubemap.get_cm_set(0), d)
        eye = camera.camera_eye(mesh.mesh_camera(6), 0.0)
        cap, spans, rows = pp.suggest_binning(scene, eye, W, H)
        assert rows is not None
        fb, overflow = pp.render_frame(
            scene, eye, 0.0, w=W, h=H, per_pixel=True, backend="pallas",
            raster_cap=cap, raster_spans=spans, raster_rows=rows,
            return_overflow=True)
        assert not bool(overflow)
        frames.append(fb.cpu().view(torch.int32))
    assert int((frames[0] != frames[1]).sum()) <= 0.003 * W * H

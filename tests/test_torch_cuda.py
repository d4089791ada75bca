"""Kernel B1 on the card: the CUDA kernel against its plain PyTorch
version, and a whole frame on the card against the same frame on the CPU.

These tests need a CUDA device and skip without one. This file imports no
jax (the card's machine has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from rustexp_tpu_torch.assets import cubemap, mesh
from rustexp_tpu_torch.ops import raster_queue as rq
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

"""Kernels B1 to B8 and the shade kernel on the card: each CUDA kernel
against its plain PyTorch version (B1 and B3 also on hand-built inputs
that stress their races, B1 and B7 on the moving camera's plane and
direct queues, the shade in every shader and form), and
whole frames on the card (queue, moving-camera, every shader, deferred
queue, bins, G-buffer oracle and band paths, the GoL and N-body
Experiments) against the same frames on the CPU; the seeded states
(core/prng.py) drawn on the card against JAX's known answers and the
CPU's draws, word for word, and run through B4, B5 and B6; and the
flagship frame of graft_entry.entry() on the card against the CPU's.

These tests need a CUDA device and skip without one. This file imports no
jax (the card's machine has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import (MOVING_EYE, SEEDED_GOL_N, moving_queue_args,
                        moving_scene, seeded_draws, seeded_kernels,
                        shade_inputs, stress_bins, stress_queue)
from rustexp_tpu_torch.app import benchmark as bench
from rustexp_tpu_torch.assets import cubemap, mesh
from rustexp_tpu_torch.core import prng, trace
from rustexp_tpu_torch.ops import gol_bits as gb
from rustexp_tpu_torch.ops import gol_stencil as gs
from rustexp_tpu_torch.ops import nbody_bh as bh
from rustexp_tpu_torch.ops import nbody_pallas as npl
from rustexp_tpu_torch.ops import raster_bins as rb
from rustexp_tpu_torch.ops import raster_queue as rq
from rustexp_tpu_torch.ops.raster_setup import (setup_triangles,
                                                setup_triangles_planar)
from rustexp_tpu_torch.ops import sort_bitonic as sb
from rustexp_tpu_torch.parallel import raster_shard
from rustexp_tpu_torch.raster import camera, pipeline as pp
from rustexp_tpu_torch.raster import shade as sd
from rustexp_tpu_torch.raster import shaders as sh
from rustexp_tpu_torch.sims.gol import GoLExperiment
from rustexp_tpu_torch.sims.nbody import NBodyExperiment, stable_orbits

W = H = 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,per_pixel,ray_world",
                         [(0, False, True), (0, True, True), (6, False, True),
                          (6, True, True), (0, True, False)])
def test_b1_kernel_matches_plain_on_card(mesh_idx, per_pixel, ray_world):
    """Bit-equal z, slot and planes under the mask, at the main path's
    512x512 shapes (procedural Killeroo and TorusKnot), and KillerooP with
    ray_world=False (the (4, 6) instantiation)."""
    dev = _card()
    scene = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0), dev)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), 0.0)
    queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H, 5)
    setup, extra, n2, n3 = pp.queue_attr_channels(
        scene, colors, eye, W, H, per_pixel=per_pixel, ray_world=ray_world)
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
@pytest.mark.parametrize("n2,n3", rq._B1_PLANES)
def test_b1_kernel_matches_plain_on_stress_queue(n2, n3):
    """The stress queue (chip_smoke.stress_queue): 2,048 pairs in one tile, so
    its pairs split across warps; coplanar copies under other ids tying
    at z == 1.0 and at -0.0/+0.0 in different splits; one id in two
    slots; a tile of empty chunks. Slot on every word, z and planes bit
    for bit under slot >= 0, and the clear (z 1.0, planes 0) elsewhere."""
    dev = _card()
    scal, rows_i, rows_f, h, w = stress_queue(n2, n3, dev)
    args = (scal, rows_i, rows_f, n2, n3, h, w)
    launches = rq.raster_attrs_queue_cuda.launches
    zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
    assert rq.raster_attrs_queue_cuda.launches == launches + 1
    zp, sp, lp = rq.raster_attrs_queue_plain(*args)
    mask = sp >= 0
    assert torch.equal(sk, sp) and mask.sum() > 1000
    assert torch.equal(zk[mask].view(torch.int32), zp[mask].view(torch.int32))
    assert torch.equal(lk[:, mask].view(torch.int32),
                       lp[:, mask].view(torch.int32))
    assert torch.all(zk[~mask] == 1.0) and torch.all(lk[:, ~mask] == 0.0)


# (mesh, the order build_queue's "auto" resolves on its moving path)
MOVING = [(0, "plane"), (6, "plane"), (9, "direct")]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,order", MOVING)
@pytest.mark.parametrize("per_pixel,ray_world", [(False, True), (True, True),
                                                 (True, False)])
def test_b1_kernel_matches_plain_on_moving_queues(mesh_idx, order, per_pixel,
                                                  ray_world):
    """B1 on the plane queues of Killeroo and TorusKnot and the direct
    queue of Cube, built as the moving camera builds them (its caps, a
    path eye), in its three forms: slot on every word, z and planes under
    the mask."""
    dev = _card()
    scene, eyes, caps = moving_scene(dev, pp, bench, mesh, cubemap,
                                     mesh_idx)
    queue, args = moving_queue_args(pp, rq, scene, eyes[MOVING_EYE], caps,
                                    "auto", per_pixel, ray_world)
    assert queue.order == order
    zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
    zp, sp, lp = rq.raster_attrs_queue_plain(*args)
    mask = sp >= 0
    assert torch.equal(sk, sp) and mask.any()
    assert torch.equal(zk[mask].view(torch.int32), zp[mask].view(torch.int32))
    assert torch.equal(lk[:, mask].view(torch.int32),
                       lp[:, mask].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,order", MOVING)
def test_b7_kernel_matches_plain_on_moving_queues(mesh_idx, order):
    """B7 on the same queues: z and slot on every word."""
    dev = _card()
    scene, eyes, caps = moving_scene(dev, pp, bench, mesh, cubemap,
                                     mesh_idx)
    queue, args = moving_queue_args(pp, rq, scene, eyes[MOVING_EYE], caps,
                                    "auto", True)
    assert queue.order == order
    zk, sk = rq.raster_zslot_queue_cuda(*args[:3], H, W)
    zp, sp = rq.raster_zslot_queue_plain(*args[:3], H, W)
    assert (sp >= 0).any() and torch.equal(sk, sp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,order", MOVING)
def test_moving_frames_on_card_match_cpu(mesh_idx, order):
    """bench_scene_moving's frame (the queue rebuilt at each eye) on the
    card equals the CPU's at two path eyes: 0 px."""
    dev = _card()
    scene, eyes, caps = moving_scene(dev, pp, bench, mesh, cubemap,
                                     mesh_idx)
    scene_c = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0),
                            "cpu")
    for eye in eyes[::40]:
        fb, ov = bench.moving_frame(scene, eye, caps, True)
        ref, _ = bench.moving_frame(scene_c, eye, caps, True)
        assert not bool(ov) and torch.equal(fb.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("per_pixel", [False, True])
def test_shader_frames_on_card_match_cpu(per_pixel):
    """All 16 shaders on Killeroo through the queue: 0 px card vs CPU."""
    dev = _card()
    eye = camera.camera_eye(mesh.mesh_camera(0), 0.0)
    scenes = {d: pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), d)
              for d in (dev, torch.device("cpu"))}
    queues = {d: pp.build_scene_queue(s_, eye, W, H, per_pixel=per_pixel)
              for d, s_ in scenes.items()}
    for i in range(sh.NUM_SHADERS):
        fbs = [pp.render_frame(s_, eye, 0.0, w=W, h=H, per_pixel=per_pixel,
                               shader_idx=i, backend="queue",
                               raster_queue=queues[d]).cpu()
               for d, s_ in scenes.items()]
        assert torch.equal(*fbs), sh.shader_name(i)


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


SHADE_H, SHADE_BW = 64, 64
SHADE_EYES = (camera.camera_eye(mesh.mesh_camera(0), 0.0),
              camera.camera_eye("orbit", 1.3))


def _shade_forms(inputs, forms=("dense", "rows", "compact")):
    """(form, (mask, z, lin), keywords) of shade_inputs over the whole
    frame, a rows list and the same list compacted."""
    mask, z, lin, bg, _, rows = inputs
    h, w = bg.shape
    n_blk = h * (w // SHADE_BW)
    rows_g = torch.where(rows >= n_blk, 0, rows).long()

    def take(p_):
        return p_.reshape(n_blk, SHADE_BW)[rows_g].contiguous()

    for form in forms:
        if form == "dense":
            yield form, (mask, z, lin), {}
        elif form == "rows":
            yield form, (mask, z, lin), dict(rows=rows, block_w=SHADE_BW)
        else:
            yield form, (take(mask), take(z), [take(p_) for p_ in lin]), \
                dict(rows=rows, block_w=SHADE_BW, compact=True)


def _shade_on_card_and_cpu(planes, bg, cm, eye, **kw):
    """(kernel frame, plain frame on the card, plain frame on the CPU),
    the kernel launched once."""
    launches = sd.shade_pack_cuda.launches
    got = sd.shade_pack(*planes, bg, cm, eye, 0.0, **kw)
    assert sd.shade_pack_cuda.launches == launches + 1
    card = sd.shade_pack_plain(*planes, bg, cm, eye, 0.0, **kw)
    cpu_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
    cpu = sd.shade_pack_plain(*([p_.cpu() for p_ in t] if isinstance(t, list)
                                else t.cpu() for t in planes),
                              bg.cpu(), cm.cpu(), eye, 0.0, **cpu_kw)
    return got.cpu(), card.cpu(), cpu


@pytest.mark.cuda
@pytest.mark.parametrize("shader_idx", range(sh.NUM_SHADERS))
def test_shade_kernel_matches_plain_on_card(shader_idx):
    """The shade kernel against the plain chain, 0 differing bits, on the
    card and against the CPU: per_pixel and ray_world each True and False,
    over the whole frame, a rows list (pads skipped, the rest background)
    and the list compacted, at two eyes, on synthetic planes whose
    shading stays below white (chip_smoke.shade_inputs); one launch a
    call."""
    dev = _card()
    for per_pixel in (False, True):
        for ray_world in (False, True):
            inputs = shade_inputs(SHADE_H, W, per_pixel, ray_world, dev,
                                  seed=shader_idx, block_w=SHADE_BW)
            bg, cm = inputs[3], inputs[4]
            for form, planes, kw in _shade_forms(inputs):
                for e, eye in enumerate(SHADE_EYES):
                    got, card, cpu = _shade_on_card_and_cpu(
                        planes, bg, cm, eye, shader_idx=shader_idx,
                        per_pixel=per_pixel, ray_world=ray_world, **kw)
                    where = (per_pixel, ray_world, form, e)
                    assert torch.equal(got, card), where
                    assert torch.equal(got, cpu), where
            covered = got[inputs[0].cpu()]
            assert len(torch.unique(covered)) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("per_pixel,ray_world", [(True, True), (True, False),
                                                 (False, False)])
def test_shade_kernel_matches_cpu_on_degenerate_pixels(per_pixel, ray_world):
    """Covered pixels whose 1/w is 0, -0 or inf, with a NaN and a negative
    colour and zero normals: the kernel's words equal the CPU's plain
    chain (NaN to 0 in the pack, clamps that pass NaN), every form."""
    dev = _card()
    inputs = shade_inputs(SHADE_H, W, per_pixel, ray_world, dev, seed=99,
                          block_w=SHADE_BW, degenerate=True)
    for form, planes, kw in _shade_forms(inputs):
        for shader_idx in (5, 6, 3, 15):
            got, _, cpu = _shade_on_card_and_cpu(
                planes, inputs[3], inputs[4], SHADE_EYES[1],
                shader_idx=shader_idx, per_pixel=per_pixel,
                ray_world=ray_world, **kw)
            assert torch.equal(got, cpu), (form, shader_idx)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [dict(y0=64, full_h=256),
                                  dict(y_rows=[(y // 16 * 4 + 1) * 16 + y % 16
                                               for y in range(SHADE_H)])])
def test_shade_kernel_matches_plain_on_band_rows(band):
    """A band of a taller frame unprojects its rays at global rows (y0 and
    full_h, or the cyclic interleave's y_rows): the kernel against the
    plain chain on the card and the CPU, whole band and rows list."""
    dev = _card()
    inputs = shade_inputs(SHADE_H, W, True, True, dev, seed=7,
                          block_w=SHADE_BW)
    for form, planes, kw in _shade_forms(inputs, ("dense", "rows")):
        for shader_idx in (5, 13):
            got, card, cpu = _shade_on_card_and_cpu(
                planes, inputs[3], inputs[4], SHADE_EYES[0],
                shader_idx=shader_idx, per_pixel=True, ray_world=True,
                **kw, **band)
            assert torch.equal(got, card) and torch.equal(got, cpu), form


def _shade_counts():
    """(shade launches, raster launches B1 + B2, eye uploads so far)."""
    return (sd.shade_pack_cuda.launches,
            rq.raster_attrs_queue_cuda.launches
            + rb.raster_attrs_bins_cuda.launches,
            trace.span_totals().get("sync.upload.eye", (0, 0))[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx", [0, 9])
def test_shade_kernel_one_launch_per_render(mesh_idx):
    """The benchmark cells' paths, KillerooP (the queue, its compacted
    ray-world shade) and CubeP (the bins, the full-frame shade):
    scene_frame's frame() at the fixed eye and the Experiment's render on
    the orbit each launch the shade kernel once per render, as often as
    the raster kernel, and open no sync.upload.eye span."""
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

    dev = _card()
    frame = bench.scene_frame(mesh_idx, True, dev)[0]
    frame()  # first use: the library loads, the gamma curve uploads
    shade0, raster0, eye0 = _shade_counts()
    for _ in range(3):
        frame()
    shade1, raster1, eye1 = _shade_counts()
    assert shade1 - shade0 == raster1 - raster0 == 3
    exp = RasterizerExperiment(dev)
    st = exp.init(mesh_idx=mesh_idx, per_pixel=True)
    exp.render(st, W, H, 0.0)
    shade1, raster1, _ = _shade_counts()
    for i in range(1, 5):
        exp.render(st, W, H, i / 60)
    shade2, raster2, eye2 = _shade_counts()
    assert shade2 - shade1 == raster2 - raster1 >= 4
    assert eye2 == eye1 == eye0


def _lone_triangle_queue(dev):
    """(scal, rows_i, rows_f, h, w) of a 48x384 frame (3 x 3 tiles) whose
    one triangle lies in the middle tile: build_queue gives that tile one
    chunk, the pad row two pad chunks, and no chunk visits the others."""
    xs = torch.tensor([[140.0], [240.0], [150.0]])
    ys = torch.tensor([[18.0], [20.0], [30.0]])
    zs = torch.full((3, 1), 0.25)
    h, w = 48, 384
    setup = setup_triangles_planar(xs, ys, zs, w, h)
    assert bool(setup.valid.all())
    queue = rq.build_queue(setup, h, w, s_cap=3, m_y=1, m_x=1, order="tri")
    assert queue.scal[:, :2].tolist() == [[1, 1], [3, 0], [3, 0]]
    rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, []))
    return tuple(t.to(dev) for t in (queue.scal, rows_i, rows_f)) + (h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,per_pixel,size",
                         [(0, True, W), (6, True, W), (0, False, W),
                          (0, True, 1024), (None, True, W)])
def test_b7_kernel_matches_plain_on_card(mesh_idx, per_pixel, size):
    """Bit-equal z and slot on every word (the clear, z 1.0 and slot -1,
    where no pair won), on the scene's queue at 512x512 and KillerooP at
    1024x1024, and on a queue whose tiles but one no chunk visits
    (mesh_idx None)."""
    dev = _card()
    if mesh_idx is None:
        args = _lone_triangle_queue(dev)
    else:
        scene = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0),
                              dev)
        eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), 0.0)
        queue = pp.build_scene_queue(scene, eye, size, size,
                                     per_pixel=per_pixel)
        colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0,
                                                         size, size, 5)
        setup, extra, _, _ = pp.queue_attr_channels(
            scene, colors, eye, size, size, per_pixel=per_pixel)
        rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
        args = (queue.scal, rows_i, rows_f, size, size)
    launches = rq.raster_zslot_queue_cuda.launches
    zk, sk = rq.raster_zslot_queue_cuda(*args)
    assert rq.raster_zslot_queue_cuda.launches == launches + 1
    zp, sp = rq.raster_zslot_queue_plain(*args)
    won = sp >= 0
    assert torch.equal(sk, sp) and won.any() and not won.all()
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


@pytest.mark.cuda
def test_b7_kernel_matches_plain_on_stress_queue():
    """B7 on the stress queue (chip_smoke.stress_queue, its (4, 0) form):
    2,048 pairs in one tile split across warps and merged, the ties at
    z == 1.0 and at -0.0/+0.0, one id in two slots, a tile of empty
    chunks and a pad-row tile no chunk visits. z and slot bit for bit on
    every word."""
    dev = _card()
    scal, rows_i, rows_f, h, w = stress_queue(4, 0, dev)
    launches = rq.raster_zslot_queue_cuda.launches
    zk, sk = rq.raster_zslot_queue_cuda(scal, rows_i, rows_f, h, w)
    assert rq.raster_zslot_queue_cuda.launches == launches + 1
    zp, sp = rq.raster_zslot_queue_plain(scal, rows_i, rows_f, h, w)
    assert torch.equal(sk, sp) and (sp >= 0).sum() > 1000
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


def _gbuffer_bins(mesh_idx, dev, h=H, y_shift=0):
    scene = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0), dev)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), 0.0)
    vp, _, _ = pp.transform_vertices(scene, eye, W, H)
    setup = setup_triangles(vp, scene.tris, W, h, y_shift=y_shift)
    bins = rb.bin_triangles(setup, h, W, rb._bins_cap(setup.A.shape[0], None))
    assert not bool(bins.overflow)
    return bins


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,h,y_shift", [(0, H, 0), (9, H, 0),
                                                (6, H, 0), (0, 128, 0),
                                                (0, 128, 256)])
def test_b3_kernel_matches_plain_on_card(mesh_idx, h, y_shift):
    """Bit-equal z, slot and b0-b2 on every word at raster_gbuffer_pallas's
    default bins: the whole 512x512 frame (Killeroo, Cube, TorusKnot) and
    128-row bands of it (y_shift)."""
    dev = _card()
    bins = _gbuffer_bins(mesh_idx, dev, h, y_shift)
    args = (bins.counts, bins.setup_i, bins.setup_f, h, W)
    launches = rb.raster_gbuffer_bins_cuda.launches
    zk, sk, bk = rb.raster_gbuffer_bins_cuda(*args)
    assert rb.raster_gbuffer_bins_cuda.launches == launches + 1
    zp, sp, bp = rb.raster_gbuffer_bins_plain(*args)
    assert (sp >= 0).any() and torch.equal(sk, sp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(bk.view(torch.int32), bp.view(torch.int32))


@pytest.mark.cuda
def test_b3_kernel_matches_plain_on_stress_bins():
    """The stress bins (chip_smoke.stress_bins): 1,163 live slots in one
    tile, split over warps and merged; copies tying at z == 1.0 and at
    +0.0/-0.0; one triangle in two slots; an empty tile; live records past
    the counts. Slot, z and b0-b2 bit for bit on every word."""
    dev = _card()
    bins, h, w = stress_bins(dev)
    args = (bins.counts, bins.setup_i, bins.setup_f, h, w)
    launches = rb.raster_gbuffer_bins_cuda.launches
    zk, sk, bk = rb.raster_gbuffer_bins_cuda(*args)
    assert rb.raster_gbuffer_bins_cuda.launches == launches + 1
    zp, sp, bp = rb.raster_gbuffer_bins_plain(*args)
    assert (sp >= 1024).any() and torch.equal(sk, sp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(bk.view(torch.int32), bp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("per_pixel", [False, True])
def test_defer_frame_on_card(per_pixel):
    """raster_and_shade_queue(defer=True) through B7 equals the planes
    frame through B1 on the card, and the CPU's defer frame."""
    dev = _card()
    frames = []
    for d in (dev, torch.device("cpu")):
        scene = pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), d)
        eye = camera.camera_eye(mesh.mesh_camera(0), 0.0)
        queue = pp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel)
        colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W,
                                                         H, 5)
        kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=5,
                  bg_fb=pp.background(0, W, H, d))
        fb, _ = pp.raster_and_shade_queue(scene, queue, colors, eye, 0.0,
                                          defer=True, **kw)
        if d.type == "cuda":
            planes, _ = pp.raster_and_shade_queue(scene, queue, colors, eye,
                                                  0.0, **kw)
            assert torch.equal(fb, planes)
        frames.append(fb.cpu())
    assert int((frames[0] != frames[1]).sum()) <= 0.003 * W * H


@pytest.mark.cuda
def test_gbuffer_frames_on_card():
    """render_frame(backend="xla") at 512x512 equals backend="pallas" on
    the card and the CPU's xla frame; the band renderer's four 128-row
    bands through B3, stitched, and render_frame_sharded(group=None,
    backend="pallas") equal the card's xla frame; the Experiment at a
    500x500 window renders through the oracle like the CPU's."""
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

    dev = _card()
    eye = camera.camera_eye(mesh.mesh_camera(0), 0.0)
    kw = dict(w=W, h=H, per_pixel=True, shader_idx=5)
    frames = []
    for d in (dev, torch.device("cpu")):
        scene = pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), d)
        frames.append(pp.render_frame(scene, eye, 0.0, backend="xla", **kw))
    assert int((frames[0].cpu() != frames[1]).sum()) <= 0.003 * W * H
    scene = pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), dev)
    assert torch.equal(frames[0], pp.render_frame(scene, eye, 0.0,
                                                  backend="pallas", **kw))
    plain = pp.render_frame(scene, eye, 0.0, backend="xla", show_cm=False,
                            **kw)
    launches = rb.raster_gbuffer_bins_cuda.launches
    bands = torch.cat([raster_shard.render_band(
        scene, eye, 0.0, band=b, n_bands=4, backend="pallas", **kw)[0]
        for b in range(4)])
    assert rb.raster_gbuffer_bins_cuda.launches == launches + 4
    assert torch.equal(bands.view(torch.uint32), plain)
    assert torch.equal(raster_shard.render_frame_sharded(
        scene, eye, 0.0, None, backend="pallas", **kw), plain)
    exp = [RasterizerExperiment(d) for d in (dev, torch.device("cpu"))]
    got = [e.render(e.init(per_pixel=True), 500, 500, 0.0).cpu() for e in exp]
    assert int((got[0] != got[1]).sum()) <= 0.003 * 500 * 500


def _grid(shape, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, shape, generator=gen, dtype=torch.int32).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("form", [None, "tiled"])
@pytest.mark.parametrize("shape,k", [((256, 256), 1), ((256, 256), 100),
                                     ((2048, 2048), 65), ((96, 160), 37),
                                     ((32, 40), 33), ((288, 256), 17),
                                     ((256, 1024), 31), ((32, 1024), 2),
                                     ((32, 1056), 16), ((32, 32), 5),
                                     ((160, 96), 0)])
def test_b4_kernel_matches_plain_on_card(shape, k, form):
    """Bit-equal packed words, the input unchanged, in the form the plan
    picks and tiled: the main path's [8, 256] (resident) and [64, 2048]
    (tiled), ragged tiles, a grid smaller than a tile, both sides of the
    resident form's limits ([8, 256] and [9, 256] word rows, [8, 1024]
    past its words, [1, 1024] and [1, 1056] columns, [1, 32] one warp,
    [3, 160] five), and k = 0, 1 and across the 16-generation launches
    (odd and even launch counts)."""
    dev = _card()
    packed = gb.pack_rows(_grid(shape, k, dev))
    before = packed.clone()
    plan = gb._b4_plan(*packed.shape, k, form)
    launches = gb.multi_step_packed_cuda.launches
    got = gb.multi_step_packed_cuda(packed, k, form)
    assert gb.multi_step_packed_cuda.launches == launches + plan.launches
    assert plan.launches == (int(k > 0) if plan.form == "resident"
                             else -(-k // 16))
    assert torch.equal(got, gb.multi_step_packed_plain(packed, k))
    assert torch.equal(packed, before)


def _gun(shape, at, dev):
    """A [shape] int32 grid holding the Gosper glider gun with its top-left
    cell at `at`, wrapped around the torus."""
    from rustexp_tpu_torch.assets.gol_patterns import GUN, pattern_to_array

    gun = torch.from_numpy(pattern_to_array(GUN)).to(torch.int32)
    g = torch.zeros(shape, dtype=torch.int32)
    g[:gun.shape[0], :gun.shape[1]] = gun
    return torch.roll(g, at, (0, 1)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,fill", [
    ((256, 256), 5, "random"), ((512, 512), 20, "random"),
    ((96, 160), 17, "random"), ((20, 30), 9, "random"),
    ((256, 256), 8, "random"), ((640, 1024), 20, "random"),
    ((256, 256), 0, "random"), ((96, 160), 1, "random"),
    ((96, 160), 150, "gun")])
def test_b8_kernel_matches_plain_on_card(shape, k, fill):
    """Bit-equal cells and the plan's launches: the GoL Experiment's call
    (256^2, 8 generations: one launch), 512^2 x 20 (three), the largest
    grid the guard allows, grids smaller than a tile, k = 0 and 1, and a
    glider gun across the torus's edges whose gliders cross the tiles'
    edges and the torus for 150 generations (19 launches)."""
    dev = _card()
    g = (_grid(shape, k, dev) if fill == "random"
         else _gun(shape, (90, 140), dev)).to(torch.float32)
    plan = gs._b8_plan(*shape, k)
    launches = gs.multi_step_pallas_cuda.launches
    got = gs.multi_step_pallas_cuda(g, k)
    assert gs.multi_step_pallas_cuda.launches == launches + plan.launches
    want = gs.multi_step_pallas_plain(g, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if fill == "gun":
        assert int(want.sum()) > int(g.sum()) + 20  # gliders were emitted


INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _b6_keys(case, n, gen):
    """int32 [n] keys of a B6 case (on the CPU)."""
    if case == "constant":
        return torch.zeros(n, dtype=torch.int32)
    if case == "signed":
        key = torch.randint(INT32_MIN, INT32_MAX, (n,), generator=gen,
                            dtype=torch.int32)
        key[:8] = torch.tensor([INT32_MIN, -1, 0, INT32_MAX] * 2,
                               dtype=torch.int32)
        return key[torch.randperm(n, generator=gen)]
    hi = {"ties": 7, "wide": 1 << 30, "morton": 1000,
          "idx": 5}.get(case, INT32_MAX)
    return torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", [("ties", 256), ("wide", 4096),
                                    ("morton", 131072), ("signed", 4096),
                                    ("constant", 256), ("idx", 4096),
                                    ("random", 1 << 20)])
def test_b6_kernel_matches_plain_on_card(case, n):
    """Bit-equal keys, idx and five payloads (f32 and int32): ties, the
    N-body's n = 131,072, full-range signed keys with INT32_MIN, -1, 0 and
    INT32_MAX, constant keys, an explicit permuted and partly negative idx
    (8 passes), and n = 2^20; the inputs are left unchanged."""
    dev = _card()
    gen = torch.Generator().manual_seed(n)
    key = _b6_keys(case, n, gen).to(dev)
    idx = None
    if case == "idx":
        idx = (torch.randperm(n, generator=gen).to(torch.int32)
               - n // 3).to(dev)
    vals = [torch.randn(n, generator=gen).to(dev) for _ in range(4)]
    vals.append(torch.randint(-9, 9, (n,), generator=gen,
                              dtype=torch.int32).to(dev))
    before = [t.clone() for t in (key, *vals)]
    launches = sb.sort_kv_cuda.launches
    kk, ik, vk = sb.sort_kv_cuda(key, idx, vals)
    # three launches (count, scan, scatter) per 8-bit pass: 4 passes on
    # the key, 4 more on an explicit idx
    assert sb.sort_kv_cuda.launches == launches + (12 if idx is None else 24)
    kp, ip, vp = sb.sort_kv_plain(key, idx, vals)
    assert torch.equal(kk, kp) and torch.equal(ik, ip)
    for a, b in zip(vk, vp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip((key, *vals), before):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1024, 16384, 16385])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("split", [True, False])
def test_b5_kernel_matches_plain_on_card(n, approx, split, monkeypatch):
    """Forces within chip_smoke.B5_RTOL of the plain version: the largest
    |dF| over the largest |F|, at N a multiple of the block's 256 targets
    and not (1,000, 16,385), with the plan's 16 source splits and their
    sum (two launches) and, the plan's block target lowered, unsplit (one
    launch)."""
    dev = _card()
    if not split:
        monkeypatch.setattr(npl, "B5_MIN_BLOCKS", 1)
    px, py, _, _, m = stable_orbits(prng.key(n), n, device=dev)
    splits, planned = npl._b5_plan(n)
    assert (splits, planned) == ((16, 2) if split else (1, 1))
    launches = npl.forces_pallas_cuda.launches
    kx, ky = npl.forces_pallas_cuda(px, py, m, approx)
    assert npl.forces_pallas_cuda.launches == launches + planned
    px_, py_ = npl.forces_pallas_plain(px, py, m)
    rel = float(torch.hypot(kx - px_, ky - py_).max()
                / torch.hypot(px_, py_).max())
    assert rel < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_gol_experiment_on_card_matches_cpu(backend):
    dev = _card()
    frames = []
    for d in (dev, torch.device("cpu")):
        exp = GoLExperiment(d)
        st = exp.init(pattern="gun", steps_per_frame=8, backend=backend)
        for _ in range(3):
            st = exp.step(st)
        frames.append(exp.render(st, 512, 512).cpu())
    assert torch.equal(frames[0], frames[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,theta", [(4096, 0.85), (1024, 0.85),
                                     (10_000, 0.85), (2048, 0.0)])
def test_nbody_experiment_on_card_matches_cpu(n, theta):
    """Three steps from the same initial conditions (BH with B6, brute B5,
    BH with argsort, brute B5 at theta 0): frames within the N-body
    golden's 1% of pixels, positions within 1e-3."""
    dev = _card()
    frames, pos = [], []
    for d in (dev, torch.device("cpu")):
        exp = NBodyExperiment(d)
        st = exp.init(n=n, theta=theta)
        for _ in range(3):
            st = exp.step(st)
        frames.append(exp.render(st, 256, 256).cpu())
        pos.append(torch.stack([st.px, st.py]).cpu())
    assert int((frames[0] != frames[1]).sum()) <= 0.01 * 256 * 256
    assert float((pos[0] - pos[1]).abs().max()) < 1e-3


@pytest.mark.cuda
def test_morton_sort_routes_agree_on_card(monkeypatch):
    dev = _card()
    px, py, vx, vy, m = stable_orbits(prng.key(5), 131072, device=dev)
    a = bh.morton_sort(px, py, m, vx, vy)
    monkeypatch.setattr(bh, "USE_BITONIC_SORT", False)
    b = bh.morton_sort(px, py, m, vx, vy)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", raster_shard.LAYOUTS)
@pytest.mark.parametrize("per_pixel", [False, True])
def test_b1_kernel_matches_plain_on_band_queues(layout, per_pixel):
    """B1 on each of 4 band queues of KillerooP/V at 512x512: translated
    contiguous bands and the cyclic interleave, whose chunks carry global
    tile rows the kernel must evaluate at. Slot bit for bit, z and planes
    under slot >= 0."""
    dev = _card()
    n_dev = 4
    band_h = H // n_dev
    cyclic = layout == "cyclic"
    scene = pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), dev)
    eye = camera.camera_eye(mesh.mesh_camera(0), 0.0)
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H, 5)
    caps = raster_shard.band_queue_caps(scene, [eye], w=W, h=H, n_dev=n_dev,
                                        layout=layout)
    for band in range(n_dev):
        queue = raster_shard.build_band_queue(scene, eye, caps, w=W, h=H,
                                              n_dev=n_dev, band=band,
                                              layout=layout)
        setup, extra, n2, n3 = pp.queue_attr_channels(
            scene, colors, eye, W, H, per_pixel=per_pixel,
            band_h=None if cyclic else band_h,
            y_shift=0 if cyclic else band * band_h)
        rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
        args = (queue.scal, rows_i, rows_f, n2, n3, band_h, W)
        zk, sk, lk = rq.raster_attrs_queue_cuda(*args)
        zp, sp, lp = rq.raster_attrs_queue_plain(*args)
        mask = sp >= 0
        assert torch.equal(sk, sp) and mask.any(), band
        assert torch.equal(zk[mask].view(torch.int32),
                           zp[mask].view(torch.int32))
        assert torch.equal(lk[:, mask].view(torch.int32),
                           lp[:, mask].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 32768])
def test_b6_merge_kv_matches_plain_on_card(n):
    """B6 in its merge_kv form (the distributed sort's merge): a bitonic
    (key, gidx) sequence with heavy ties, one half of Batcher's split of
    two sorted runs, against sort_kv_plain; 24 launches (explicit idx)."""
    dev = _card()
    gen = torch.Generator().manual_seed(n)
    key = torch.randint(-20, 20, (2 * n,), generator=gen, dtype=torch.int32)
    gidx = torch.randperm(2 * n, generator=gen).to(torch.int32)
    val = torch.randn(2 * n, generator=gen)
    k2, g2, (v2,) = sb.sort_kv_plain(key, gidx, [val])
    a_k, a_g, a_v = k2[:n], g2[:n], v2[:n]
    b_k, b_g, b_v = k2[n:].flip(0), g2[n:].flip(0), v2[n:].flip(0)
    mine = (a_k < b_k) | ((a_k == b_k) & (a_g < b_g))
    key, gidx = torch.where(mine, a_k, b_k), torch.where(mine, a_g, b_g)
    val = torch.where(mine, a_v, b_v)
    launches = sb.sort_kv_cuda.launches
    kk, gk, (vk,) = sb.merge_kv(key.to(dev), gidx.to(dev), [val.to(dev)])
    assert sb.sort_kv_cuda.launches == launches + 24
    kp, gp, (vp,) = sb.sort_kv_plain(key, gidx, [val])
    assert torch.equal(kk.cpu(), kp) and torch.equal(gk.cpu(), gp)
    assert torch.equal(vk.cpu().view(torch.int32), vp.view(torch.int32))


@pytest.mark.cuda
def test_seeded_states_on_card_match_cpu_and_jax():
    """jax.random's known answers (split, uniform at the JAX package's
    three bounds, the 2048^2 GoL R grid, stable orbits at 131,072 within
    2 ulps) drawn on the card, and the card's GoL R grid, stable orbits
    and W-key disk equal to the CPU's word for word; then B4, B5 and B6
    on those states against their plain versions."""
    dev = _card()
    bad, drawn = seeded_draws(dev)
    assert bad == []
    assert drawn["grid"].device.type == "cuda"
    rec = seeded_kernels(dev, gb, sb, bh, npl, drawn["grid"],
                         drawn["orbits"])
    for kernel, cmp in rec.items():
        for label, r in cmp.items():
            assert r["bad"] == 0, (kernel, label, r)


@pytest.mark.cuda
def test_gol_bits_banded_launches_b4_on_card():
    """backend "bits_banded" is B4 (the JAX package's banded SWAR route):
    one step of 8 generations from the 2048^2 R grid launches B4 as its
    plan says and gives the CPU's grid."""
    dev = _card()
    grids = []
    for d in (dev, torch.device("cpu")):
        exp = GoLExperiment(d)
        st = exp.handle_key(exp.init(n=SEEDED_GOL_N, backend="bits_banded",
                                     steps_per_frame=8), "R")
        launches = gb.multi_step_packed_cuda.launches
        st = exp.step(st)
        if d.type == "cuda":
            assert (gb.multi_step_packed_cuda.launches - launches
                    == gb._b4_plan(SEEDED_GOL_N // 32, SEEDED_GOL_N,
                                   8).launches)
        grids.append(st.grid.cpu())
    assert torch.equal(grids[0], grids[1])


@pytest.mark.cuda
def test_graft_entry_frame_on_card_matches_cpu():
    """graft_entry.entry()'s flagship frame (Cube, 512^2, per-pixel,
    shader 5, "auto") on the card equals entry("cpu")'s at 0 px, and
    launches B2 once and no other kernel."""
    from rustexp_tpu_torch import graft_entry
    from rustexp_tpu_torch.app.multidev import kernel_launches

    _card()
    fn, args = graft_entry.entry()
    before = kernel_launches()
    fb = fn(*args)
    torch.cuda.synchronize()
    after = kernel_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"B2": 1}
    cfn, cargs = graft_entry.entry("cpu")
    assert fb.shape == (H, W) and fb.dtype == torch.uint32
    assert torch.equal(fb.cpu().view(torch.int32),
                       cfn(*cargs).view(torch.int32))

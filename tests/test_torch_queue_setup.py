"""Kernel T's seams on the CPU (ops/raster_queue.py queue_setup_cuda).

On the card the flat queue's transform, triangle setup and channel table
are one launch of kernel T; CPU tensors keep the plain chain
(raster/pipeline.py transform_corners_planar, setup_triangles_planar, the
planar channels, pack_table), which T repeats op for op and the card tests
(tests/test_torch_cuda.py) hold it to word for word. Here: CPU frames on
every queue path never reach T, the wrapper refuses what it cannot launch
before it loads anything, B1's table comes from the setup only when the
attribute channels are its columns, and the host matrix T takes by value
is, bit for bit, the torch chain's.
"""

import hashlib

import numpy as np
import pytest
import torch

from rustexp_tpu_torch.app import benchmark as bench
from rustexp_tpu_torch.assets import cubemap, mesh
from rustexp_tpu_torch.ops import raster_queue as rq
from rustexp_tpu_torch.ops.raster_setup import dilate_setup_planar
from rustexp_tpu_torch.raster import camera
from rustexp_tpu_torch.raster import pipeline as pp
from rustexp_tpu_torch.raster import structure as rs
from rustexp_tpu_torch.raster.exact import _cross3_exact, _mm4_exact
from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

CPU = torch.device("cpu")
W = H = 128

# sha256 of scene_frame(0, per_pixel=True)'s CPU frame (uint32,
# little-endian) as the plain chain rendered it before kernel T existed.
SPHERE_P_FRAME = (
    "4a47276954b90a348a4032584d566efd3507b9de8b29ef66dde1105de2115e8a")


@pytest.fixture
def no_kernel_t(monkeypatch):
    """Make any route to kernel T raise, and hold its launch count."""
    real = rq.queue_setup_cuda
    before = real.launches

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU frame reached kernel T")

    monkeypatch.setattr(rq, "queue_setup_cuda", refuse)
    monkeypatch.setattr(pp, "queue_setup_cuda", refuse)
    monkeypatch.setattr(rq, "_t_kernel", refuse)
    yield
    assert real.launches == before


def _sphere(dev=CPU):
    return pp.make_scene(mesh.get_mesh(0), cubemap.get_cm_set(0), dev)


def _eye(tick=0.0):
    return camera.camera_eye(mesh.mesh_camera(0), tick)


def test_cpu_bench_frame_takes_the_plain_chain(no_kernel_t):
    """The sphere bench cell's frame on the CPU: the plain chain, the
    frame it rendered before kernel T, bit for bit."""
    fb, stale = bench.scene_frame(0, True, CPU)[0]()
    assert not bool(stale)
    got = hashlib.sha256(
        fb.view(torch.int32).numpy().astype("<i4").tobytes()).hexdigest()
    assert got == SPHERE_P_FRAME


@pytest.mark.parametrize("per_pixel,ray_world,defer", [
    (True, True, False), (True, False, False), (False, True, False),
    (True, True, True)])
def test_cpu_queue_frames_take_the_plain_chain(no_kernel_t, per_pixel,
                                               ray_world, defer):
    """Every argument set of queue_attr_channels (per pixel with and
    without ray_world, V mode) and the deferred frame render on the CPU
    without kernel T, and the deferred frame is the planes frame."""
    scene, eye = _sphere(), _eye()
    queue = rs.build(scene, rs.QUEUE, eye, W, H, per_pixel=per_pixel).data
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H,
                                                     5)
    bg = pp.background(0, W, H, CPU)
    kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=5, bg_fb=bg,
              ray_world=ray_world)
    fb, stale = pp.raster_and_shade_queue(scene, queue, colors, eye, 0.0,
                                          defer=defer, **kw)
    assert not bool(stale) and bool((fb != bg).any())
    if defer:
        planes, _ = pp.raster_and_shade_queue(scene, queue, colors, eye, 0.0,
                                              **kw)
        assert torch.equal(fb, planes)


def test_cpu_rebuilds_and_bands_take_the_plain_chain(no_kernel_t):
    """The Experiment's stale rebuild (structure.queue_setup), queue_at
    and a band of the band renderer (band_h, y_shift) on the CPU."""
    exp = RasterizerExperiment(CPU)
    st = exp.init(mesh_idx=0, per_pixel=True)
    for i in range(3):
        exp.render(st, W, H, i / 60)
    caps = rs.queue_caps([rq.read_queue_stats(rs.queue_setup(
        _sphere(), _eye(), W, H), H, W)])
    assert rs.queue_at(_sphere(), _eye(), W, H, caps).kind == rs.QUEUE
    scene = _sphere()
    setup, extra, _, _ = pp.queue_attr_channels(
        scene, None, _eye(), W, H, per_pixel=True, band_h=H // 4,
        y_shift=H // 2)
    full = rs.queue_setup(scene, _eye(), W, H)
    assert torch.equal(setup.min_x, full.min_x) and setup.table is None
    assert not torch.equal(setup.min_y, full.min_y)


def _tensors(dev=CPU):
    """Kernel T's inputs of the sphere: (cp3, cn3, cc3, ndim, it33, m)."""
    s = _sphere(dev)
    return [s.cp3, s.cn3, s.cc3, s.ndim, s.it33,
            pp._world_to_vp_exact(pp._host_eye(_eye()), W, H)]


@pytest.mark.parametrize("case,why", [
    ("cpu", "CUDA tensors"), ("dtype", "cp3"), ("shape", "cn3"),
    ("device", "it33"), ("n3", "n3 in"), ("no_colors", "needs colors"),
    ("colors", "only with n3=0"), ("tris", "tris"), ("matrix", "16 host"),
    ("frame", "frame")])
def test_queue_setup_cuda_refuses_before_loading(case, why, monkeypatch):
    """The wrapper raises ValueError on CPU tensors, a wrong dtype, shape
    or device, an n3 it is not built for, colours without n3=0 or n3=0
    without them, a tris table of another length, a matrix that is not 16
    host values and an empty frame, all before it loads the library."""
    monkeypatch.setattr(rq, "load_kernel_lib", lambda name: pytest.fail(
        f"loaded {name}"))
    cp3, cn3, cc3, ndim, it33, m = _tensors()
    kw = {}
    w = h = W
    if case == "dtype":
        cp3 = cp3.double()
    elif case == "shape":
        cn3 = cn3[:, :2]
    elif case == "device":
        it33 = it33.to("meta")
    elif case == "n3":
        kw["n3"] = 4
    elif case == "no_colors":
        kw["n3"] = 0
    elif case == "colors":
        kw.update(n3=3, colors=torch.zeros((5, 3)))
    elif case == "tris":
        kw.update(n3=0, colors=torch.zeros((5, 3)),
                  tris=torch.zeros((7, 3), dtype=torch.int32))
    elif case == "matrix":
        m = m[:3, :3]
    elif case == "frame":
        h = 0
    with pytest.raises(ValueError, match=why):
        rq.queue_setup_cuda(cp3, cn3, cc3, ndim, it33, m, w, h, **kw)


@pytest.mark.parametrize("per_pixel", [True, False])
def test_b1_reads_the_setups_table_only_for_its_columns(per_pixel):
    """A setup that carries a table gives B1 that table when the channels
    are as many as its attribute columns (kernel T's case, where they are
    those columns), and pack_table's otherwise or with no table; both
    frames equal the plain one."""
    scene, eye = _sphere(), _eye()
    queue = rs.build(scene, rs.QUEUE, eye, W, H, per_pixel=per_pixel).data
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, W, H,
                                                     5)
    setup, extra, n2, n3 = pp.queue_attr_channels(
        scene, colors, eye, W, H, per_pixel=per_pixel)
    tab = rq.pack_table(setup, extra)
    cols = list(tab[:-1, rq._I_CH + rq._F_CH:].unbind(1))
    with_tab = setup._replace(table=tab)
    assert rq._channel_table(with_tab, cols) is tab
    assert rq._channel_table(with_tab, cols[:-1]) is not tab
    assert rq._channel_table(setup, extra) is not tab
    assert torch.equal(rq._channel_table(setup, extra).view(torch.int32),
                       tab.view(torch.int32))
    want = rq.raster_attrs_queue(queue, setup, extra, n2, n3, H, W)
    got = rq.raster_attrs_queue(queue, with_tab, cols, n2, n3, H, W)
    for a, b in zip(want[:2] + (torch.stack(want[2]),),
                    got[:2] + (torch.stack(got[2]),)):
        assert torch.equal(a, b)
    assert dilate_setup_planar(with_tab, 4, W, H).table is None


def _look_at_torch(eye, at, up):
    """look_at as the frame computed it in torch ops before kernel T."""
    dot = pp._dot3_exact
    za = eye - at
    za = za / torch.sqrt(dot(za, za))
    xa = _cross3_exact(up, za)
    xa = xa / torch.sqrt(dot(xa, xa))
    ya = _cross3_exact(za, xa)
    ne = -eye
    return torch.stack([
        torch.stack([xa[0], xa[1], xa[2], dot(ne, xa)]),
        torch.stack([ya[0], ya[1], ya[2], dot(ne, ya)]),
        torch.stack([za[0], za[1], za[2], dot(ne, za)]),
        torch.tensor([0.0, 0.0, 0.0, 1.0])])


@pytest.mark.parametrize("w,h", [(512, 512), (256, 144), (384, 48)])
def test_host_matrix_keeps_its_bits(w, h):
    """The world-to-viewport matrix kernel T takes by value (numpy
    float32 ops, torch's square root, the (w, h) part cached) equals, bit
    for bit, the torch chain it replaced: viewport @ perspective @
    look_at in m4_mul order, at every camera path's eyes and at eyes
    drawn over four decades of distance."""
    g = np.random.default_rng(w + h)
    eyes = [camera.camera_eye(c, t) for c in camera.CAMERAS
            for t in np.linspace(0.0, 20.0, 60)]
    eyes += list(g.normal(size=(300, 3)).astype(np.float32)
                 * g.uniform(0.01, 100.0, (300, 1)).astype(np.float32))
    proj = _mm4_exact(pp.viewport_matrix(w, h),
                      pp.perspective(45.0, w / h, 0.1, 10.0))
    for eye in eyes:
        eye = pp._host_eye(eye)
        want = _mm4_exact(proj, _look_at_torch(
            eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])))
        got = pp._world_to_vp_exact(eye, w, h)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

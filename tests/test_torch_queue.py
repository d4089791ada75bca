"""PyTorch port vs the JAX package: corner transform, triangle setup, the
flat-queue build (order="tri") and the plain version of kernel B1.

Small shapes: mesh.make_sphere(16, 32) (1,024 triangles, the queue path)
at 128x128. Every comparison is exact; z and the attribute planes are
compared under the coverage mask (outside it they are unspecified in both
packages).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.ops import raster_queue as jrq
from rustexp_tpu.ops.raster_setup import setup_triangles_planar as jsetup
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.ops import raster_queue as trq
from rustexp_tpu_torch.raster import pipeline as tpp

W = H = 128
CPU = torch.device("cpu")
EYES = (camera.cam_orbit(0.7), camera.cam_pan_front(1.3),
        camera.cam_orbit_front(2.0))


@pytest.fixture(scope="module")
def scenes():
    m = jmesh.make_sphere(16, 32)
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))


_jit_corners = jax.jit(jpp.transform_corners_planar, static_argnums=(2, 3))
_jit_setup = jax.jit(jsetup, static_argnums=(3, 4))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tuple_equal(a, b, what):
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape and np.array_equal(x, y), f"{what}.{f}"


def _setups(scenes, eye):
    sj, st = scenes
    xj = _jit_corners(sj, jnp.asarray(eye), W, H)
    return _jit_setup(*xj[:3], W, H), tpp._queue_setup(st, eye, W, H)


@pytest.mark.parametrize("eye_i", range(len(EYES)))
def test_transform_and_setup_match_jax(scenes, eye_i):
    sj, st = scenes
    eye = EYES[eye_i]
    xj = _jit_corners(sj, jnp.asarray(eye), W, H)
    xt = tpp.transform_corners_planar(st, eye, W, H)
    for name, a, b in zip("xs ys zs iw n world".split(), xj, xt):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    vj = jax.jit(jpp.transform_vertices, static_argnums=(2, 3))(
        sj, jnp.asarray(eye), W, H)
    for a, b in zip(vj, tpp.transform_vertices(st, eye, W, H)):
        assert np.array_equal(np.asarray(a), b.numpy())
    setj, sett = _setups(scenes, eye)
    _assert_tuple_equal(setj, sett, "TriSetupP")
    _assert_tuple_equal(setj.to_trisetup(), sett.to_trisetup(), "TriSetup")


def _tri_queues(scenes, eye, shade_w):
    setj, sett = _setups(scenes, eye)
    stats = tuple(int(x) for x in jrq.queue_stats(setj, H, W))
    assert stats == tuple(int(x) for x in trq.queue_stats(sett, H, W))
    cfg = jrq.suggest_queue_config(stats)
    assert cfg == trq.suggest_queue_config(stats)
    kw = dict(s_cap=cfg[0], m_y=cfg[1], m_x=cfg[2], t_cap=cfg[3],
              shade_w=shade_w)
    return (jrq.build_queue(setj, H, W, order="tri", **kw),
            trq.build_queue(sett, H, W, order="tri", **kw), setj, sett)


@pytest.mark.parametrize("shade_w", [jrq.SHADE_W, jrq.TILE_W])
def test_build_queue_tri_matches_jax(scenes, shade_w):
    qj, qt, _, _ = _tri_queues(scenes, EYES[0], shade_w)
    _assert_tuple_equal(qj, qt, "Queue")
    assert type(qt.shade_w) is int and qt.shade_w == shade_w
    assert not bool(qt.overflow) and int(qt.scal[:, 3].sum()) > 0


def test_choose_shade_w_matches_jax():
    for occ in ((10, 10), (10, 6), (100, 45), (0, 0), (7, 4)):
        for kw in ({}, {"rebuild_per_frame": True}, {"per_pixel": False}):
            assert trq.choose_shade_w(*occ, **kw) == jrq.choose_shade_w(
                *occ, **kw)


def test_check_queue_valid_matches_jax(scenes):
    qj, qt, _, _ = _tri_queues(scenes, EYES[0], jrq.SHADE_W)
    for eye in (EYES[0], camera.cam_orbit(0.72), EYES[1]):
        setj, sett = _setups(scenes, eye)
        want = bool(jrq.check_queue_valid(qj, setj))
        assert bool(trq.check_queue_valid(qt, sett)) == want
    assert not want  # the last eye is far outside the built queue


def test_pack_table_and_gather_rows_match_jax(scenes):
    qj, qt, setj, sett = _tri_queues(scenes, EYES[0], jrq.SHADE_W)
    rng = np.random.default_rng(7)
    extra = rng.normal(size=(3 * 5, setj.valid.shape[0])).astype(np.float32)
    tj = jrq.pack_table(setj, list(extra))
    tt = trq.pack_table(sett, list(map(torch.from_numpy, extra)))
    assert np.array_equal(np.asarray(tj).view(np.int32),
                          tt.numpy().view(np.int32))
    for a, b in zip(jrq.gather_rows(qj, tj), trq.gather_rows(qt, tt)):
        assert np.array_equal(np.asarray(a).view(np.int32),
                              b.numpy().view(np.int32))


@pytest.mark.parametrize("per_pixel", [False, True])
def test_b1_plain_matches_jax_kernel(scenes, per_pixel):
    """The plain version of B1 on a JAX-built queue (its own "auto" order,
    carried over with interop) against JAX raster_attrs_queue, which runs
    the Pallas kernel in interpret mode here: mask, z and every plane."""
    sj, st = scenes
    eye = EYES[2]
    qj = jpp.build_scene_queue(sj, eye, W, H, per_pixel=per_pixel)
    qt = interop.queue_from_numpy(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, CPU)
    colors = None if per_pixel else tpp.vertex_colors(st, eye, 0.0, W, H, 5)
    sett, extra, n2, n3 = tpp.queue_attr_channels(st, colors, eye, W, H,
                                                  per_pixel=per_pixel)
    setj, _ = _setups(scenes, eye)
    zj, mj, lj, sj_ = jrq.raster_attrs_queue(
        qj, setj, tuple(jnp.asarray(e.numpy()) for e in extra), n2, n3, H, W)
    zt, mt, lt, st_ = trq.raster_attrs_queue(qt, sett, extra, n2, n3, H, W)
    mj = np.asarray(mj)
    assert mj.sum() > 0 and np.array_equal(mt.numpy(), mj)
    assert np.array_equal(np.asarray(zj)[mj].view(np.int32),
                          zt.numpy()[mj].view(np.int32))
    assert len(lt) == len(lj) == n2 + n3
    for a, b in zip(lj, lt):
        assert np.array_equal(np.asarray(a)[mj].view(np.int32),
                              b.numpy()[mj].view(np.int32))
    assert bool(sj_) == bool(st_) is False


def test_b1_plain_race_tie_break():
    """Two coplanar copies of one triangle tie on z everywhere: the lower
    triangle id wins, whatever order the queue presents them in, and a
    fragment at exactly z == 1.0 still beats the depth clear (the JAX
    kernel's INT32_MAX tie-scratch quirk, ROADMAP C)."""
    xs = torch.tensor([[8.0, 8.0], [120.0, 120.0], [8.0, 8.0]])
    ys = torch.tensor([[2.0, 2.0], [2.0, 2.0], [14.0, 14.0]])
    zs = torch.ones((3, 2))
    setup = tpp.setup_triangles_planar(xs, ys, zs, W, 16)
    extra = [torch.tensor([1.0, 2.0]), torch.zeros(2), torch.zeros(2)]
    tab = trq.pack_table(setup, extra)
    for order in ([0, 1], [1, 0]):
        ids = torch.full((1, trq.CHUNK), -1, dtype=torch.int32)
        ids[0, :2] = torch.tensor(order)
        scal = torch.tensor([[0, 0, 1, 2, 0]], dtype=torch.int32)
        q = trq.Queue(ids, scal, *[None] * 6, shade_w=trq.TILE_W)
        rows_i, rows_f = trq.gather_rows(q, tab)
        z, slot, lin = trq.raster_attrs_queue_plain(scal, rows_i, rows_f,
                                                    1, 0, 16, W)
        covered = slot[:16] >= 0
        assert covered.sum() > 100
        assert torch.all(z[:16][covered] == 1.0)
        assert torch.all(lin[0, :16][covered] == 1.0)  # triangle 0's plane
        assert torch.all(slot[:16][covered] == order.index(0))

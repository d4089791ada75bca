"""PyTorch port vs the JAX package: the flat-queue band path (ROADMAP A16).

Band by band in this process, with the band passed explicitly: the band
and cyclic queues of build_queue's three orders and of
build_band_queues, leaf for leaf against JAX's (whose stacked leaves
hold band d at index d); the strided queue_stats; the interleave's rows;
the banded background and _shade_compacted at global rows (y0/full_h and
y_rows); transform_corners; and every band of the V and P queue frames,
cached and rebuilt per frame (the moving form), against JAX's
make_sharded_queue_render and make_sharded_queue_render_moving on a
4-device mesh and against the port's one-rank queue frame. Then one
spawn of 4 gloo ranks (tests/torch_shard_ranks.py, no jax in the
children) runs both layouts through the collectives.

make_sphere(12, 24) (576 triangles) at 128x128 over 4 bands; the
16-triangle-row cyclic case needs 128 / 16 = 8 tile rows, 2 a band.
Everything is compared bit for bit: 0 differing words or pixels.
Wall time on the test machine: about 60 s alone.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.ops import raster_queue as jrq
from rustexp_tpu.ops import raster_setup as jrs
from rustexp_tpu.parallel import raster_shard as jshard
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.assets import mesh as tmesh
from rustexp_tpu_torch.ops import raster_queue as trq
from rustexp_tpu_torch.parallel import collectives as coll
from rustexp_tpu_torch.parallel import raster_shard as tshard
from rustexp_tpu_torch.raster import pipeline as tpp

import torch_shard_ranks

W = H = 128
D = 4
CPU = torch.device("cpu")
SPHERE = (12, 24)
EYE = np.asarray(camera.cam_orbit(0.7), np.float32)
TICK = 0.5
CAP_EYES = [np.asarray(camera.cam_orbit(t), np.float32) for t in (0.6, 0.7)]
LEAVES = ("ids", "scal", "ranges", "built_valid", "overflow", "rows",
          "ylim", "xlim")


@functools.cache
def _scenes():
    m = SPHERE
    return (jpp.make_scene(jmesh.make_sphere(*m), jcubemap.make_procedural_set()),
            tpp.make_scene(tmesh.make_sphere(*m), tcubemap.make_procedural_set(),
                           CPU))


@functools.cache
def _mesh():
    return Mesh(np.array(jax.devices()[:D]), axis_names=("rows",))


def _teye():
    return torch.from_numpy(EYE)


def _bits(fb) -> np.ndarray:
    if isinstance(fb, torch.Tensor):
        return fb.view(torch.int32).numpy()
    return np.asarray(fb).view(np.int32)


def _assert_queue_equal(jq, tq, d=None, what=""):
    for f in LEAVES:
        a = np.asarray(getattr(jq, f))
        a = a if d is None else a[d]
        b = getattr(tq, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), (what, d, f)
    assert int(jq.shade_w) == tq.shade_w


@functools.cache
def _jax_band_queue_fn(layout, order, caps):
    """JAX's per-band build (build_band_queues' band_queue) with an
    explicit order, jitted once; the band index is traced."""
    s_cap, m_y, m_x, t_cap = caps
    band_h = H // D

    @jax.jit
    def build(scene, eye, d):
        xs, ys, zs, _, _, _ = jpp.transform_corners_planar(scene, eye, W, H)
        if layout == "cyclic":
            setup = jrs.setup_triangles_planar(xs, ys, zs, W, H)
            return jrq.build_queue(setup, H, W, s_cap=s_cap, m_y=m_y,
                                   m_x=m_x, t_cap=t_cap, order=order,
                                   row_stride=D, row_offset=d)
        setup = jrs.setup_triangles_planar(xs, ys, zs, W, band_h,
                                           y_shift=d * band_h)
        return jrq.build_queue(setup, band_h, W, s_cap=s_cap, m_y=m_y,
                               m_x=m_x, t_cap=t_cap, order=order)

    return build


@pytest.mark.parametrize("order", ["tri", "plane", "direct"])
@pytest.mark.parametrize("layout", ["bands", "cyclic"])
def test_band_queues_match_jax_in_each_order(layout, order):
    """Every band's queue of each slot order, leaf for leaf: the plane
    order's run table reads global tile rows, the tri order keeps only
    the band's pairs, the direct order ranks the band's coverage."""
    js, ts = _scenes()
    caps = tuple(int(c) for c in jshard.band_queue_caps(
        js, [jnp.asarray(EYE)], w=W, h=H, n_dev=D, layout=layout))
    assert caps == tshard.band_queue_caps(ts, [_teye()], w=W, h=H, n_dev=D,
                                          layout=layout)
    build = _jax_band_queue_fn(layout, order, caps)
    s_cap, m_y, m_x, t_cap = caps
    for d in range(D):
        setup = tshard._band_setup(ts, _teye(), w=W, h=H, n_dev=D, band=d,
                                   layout=layout)
        kw = dict(row_stride=D, row_offset=d) if layout == "cyclic" else {}
        tq = trq.build_queue(setup, H if layout == "cyclic" else H // D, W,
                             s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap,
                             order=order, **kw)
        assert tq.order == order
        _assert_queue_equal(build(js, jnp.asarray(EYE), jnp.int32(d)), tq,
                            what=f"{layout} {order}")


@pytest.mark.parametrize("layout", ["bands", "cyclic"])
def test_build_band_queues_match_jax(layout):
    """build_band_queues (unified caps, the default order): band d of the
    port's list equals index d of JAX's stacked queues; the one-rank form
    of the caps equals the group form (checked over ranks below)."""
    js, ts = _scenes()
    jq = jshard.build_band_queues(js, jnp.asarray(EYE), w=W, h=H, n_dev=D,
                                  layout=layout)
    tq = tshard.build_band_queues(ts, _teye(), w=W, h=H, n_dev=D,
                                  layout=layout)
    assert len(tq) == D
    for d in range(D):
        _assert_queue_equal(jq, tq[d], d, layout)


def test_strided_queue_stats_match_jax():
    """queue_stats of each cyclic band (row_stride D, row_offset d) and of
    the whole frame, all five numbers."""
    js, ts = _scenes()
    xs, ys, zs, _, _, _ = jpp.transform_corners_planar(js, jnp.asarray(EYE),
                                                       W, H)
    jsetup = jrs.setup_triangles_planar(xs, ys, zs, W, H)
    tsetup = tshard._band_setup(ts, _teye(), w=W, h=H, n_dev=D, band=0,
                                layout="cyclic")
    for stride, offsets in ((1, (0,)), (D, range(D)), (2, (0, 1))):
        for off in offsets:
            want = [int(x) for x in jrq.queue_stats(
                jsetup, H, W, row_stride=stride, row_offset=off)]
            got = [int(x) for x in trq.queue_stats(tsetup, H, W, stride, off)]
            assert got == want, (stride, off)


def test_build_queue_interleave_refusals():
    _, ts = _scenes()
    setup = tshard._band_setup(ts, _teye(), w=W, h=H, n_dev=D, band=0,
                               layout="cyclic")
    with pytest.raises(ValueError, match="row_stride=3"):
        trq.build_queue(setup, H, W, s_cap=16, m_y=2, m_x=2, row_stride=3)
    with pytest.raises(ValueError, match="row_offset"):
        trq.build_queue(setup, H, W, s_cap=16, m_y=2, m_x=2, row_stride=2,
                        row_offset=2)
    with pytest.raises(ValueError, match="not divisible by 3"):
        tshard.queue_band(ts, None, _teye(), TICK, band=0, n_dev=3, w=W, h=H)
    with pytest.raises(ValueError, match="tile rows not divisible"):
        tshard.queue_band(ts, None, _teye(), TICK, band=0, n_dev=16, w=W,
                          h=H, layout="cyclic")
    with pytest.raises(ValueError, match="layout"):
        tshard.queue_band(ts, None, _teye(), TICK, band=0, n_dev=D, w=W,
                          h=H, layout="rows")


def test_interleave_rows_match_jax():
    band_h = H // D
    for d in range(D):
        assert np.array_equal(
            tshard.interleave_y_rows(band_h, D, d).numpy(),
            np.asarray(jshard.interleave_y_rows(band_h, D, d, trq.TILE_H)))
    rng = np.random.default_rng(3)
    fb = rng.integers(-2**31, 2**31, (H, W), dtype=np.int64).astype(np.int32)
    assert np.array_equal(
        tshard.deinterleave_rows(torch.from_numpy(fb), D).numpy(),
        np.asarray(jshard.deinterleave_rows(jnp.asarray(fb), D, trq.TILE_H)))


@pytest.mark.parametrize("bg_idx", [0, 1])
def test_band_background_matches_jax(bg_idx):
    """The gradient of a band at global rows: y0/full_h and y_rows."""
    band_h = H // D
    for d in range(D):
        rows = tshard.interleave_y_rows(band_h, D, d)
        got = tpp.background(bg_idx, W, band_h, CPU, full_h=H, y_rows=rows)
        want = jpp.background(bg_idx, W, band_h, full_h=H,
                              y_rows=jnp.asarray(rows.numpy()))
        assert np.array_equal(got.numpy(), np.asarray(want))
        got = tpp.background(bg_idx, W, band_h, CPU, y0=d * band_h, full_h=H)
        want = jpp.background(bg_idx, W, band_h, y0=d * band_h, full_h=H)
        assert np.array_equal(got.numpy(), np.asarray(want))


def _cyclic_band_planes(ts, d):
    """The port's B1 outputs (plain version) of cyclic band d, as numpy:
    the inputs both _shade_compacted's are given."""
    band_h = H // D
    caps = tshard.band_queue_caps(ts, [_teye()], w=W, h=H, n_dev=D,
                                  layout="cyclic")
    queue = tshard.build_band_queue(ts, _teye(), caps, w=W, h=H, n_dev=D,
                                    band=d, layout="cyclic")
    setup, extra, n2, n3 = tpp.queue_attr_channels(ts, None, _teye(), W, H,
                                                   per_pixel=True)
    z, mask, lin, _ = trq.raster_attrs_queue(queue, setup, extra, n2, n3,
                                             band_h, W)
    return queue, z, mask, lin


@pytest.mark.parametrize("form", ["y_rows", "y0"])
def test_shade_compacted_at_global_rows_matches_jax(form):
    """_shade_compacted of a band whose rays are unprojected at global
    rows, on the same planes, bit for bit: the cyclic interleave's y_rows
    and the contiguous band's y0/full_h."""
    js, ts = _scenes()
    band_h = H // D
    d = 2
    queue, z, mask, lin = _cyclic_band_planes(ts, d)
    rows = tshard.interleave_y_rows(band_h, D, d)
    kw_t = (dict(y_rows=rows) if form == "y_rows"
            else dict(y0=d * band_h))
    kw_j = (dict(y_rows=jnp.asarray(rows.numpy())) if form == "y_rows"
            else dict(y0=jnp.float32(d * band_h)))
    bg = tpp.background(0, W, band_h, CPU, full_h=H, **kw_t)
    got = tpp._shade_compacted(queue.rows, ts, z, mask, lin, _teye(), TICK,
                               5, bg, W, band_h, block_w=queue.shade_w,
                               full_h=H, **kw_t)
    want = jpp._shade_compacted(
        jnp.asarray(queue.rows.numpy()), js, jnp.asarray(z.numpy()),
        jnp.asarray(mask.numpy()), tuple(jnp.asarray(p.numpy()) for p in lin),
        jnp.asarray(EYE), jnp.float32(TICK), 5, jnp.asarray(bg.numpy()), W,
        band_h, True, full_h=H, block_w=queue.shade_w, **kw_j)
    assert int((got.numpy() != np.asarray(want)).sum()) == 0
    assert int(mask.sum()) > 0


def test_transform_corners_matches_jax():
    js, ts = _scenes()
    vp_c, n_c = tpp.transform_corners(ts, _teye(), W, H)
    jvp_c, jn_c = jpp.transform_corners(js, jnp.asarray(EYE), W, H)
    assert np.array_equal(vp_c.numpy(), np.asarray(jvp_c))
    assert np.array_equal(n_c.numpy(), np.asarray(jn_c))
    vp, _, nw = tpp.transform_vertices(ts, _teye(), W, H)
    flat = ts.tris.reshape(-1).long()
    assert torch.equal(vp[flat], vp_c) and torch.equal(nw[flat], n_c)


@functools.cache
def _jax_frames(layout, per_pixel):
    """JAX's sharded queue frames on the 4-device mesh: cached queues and
    the in-graph rebuild; both rank-major."""
    js, _ = _scenes()
    eye = jnp.asarray(EYE)
    queues = jshard.build_band_queues(js, eye, w=W, h=H, n_dev=D,
                                      layout=layout)
    render = jshard.make_sharded_queue_render(
        _mesh(), js, eye, w=W, h=H, per_pixel=per_pixel, shader_idx=5,
        layout=layout)
    fb, stale = render(js, queues, eye, jnp.float32(TICK))
    moving = jshard.make_sharded_queue_render_moving(
        _mesh(), js, [jnp.asarray(e) for e in CAP_EYES], w=W, h=H,
        per_pixel=per_pixel, shader_idx=5, layout=layout)
    fbm, stale_m = moving(js, eye, jnp.float32(TICK))
    assert not bool(stale) and not bool(stale_m)
    return _bits(fb), _bits(fbm)


@functools.cache
def _one_rank_frame(per_pixel):
    _, ts = _scenes()
    q = tpp.build_scene_queue(ts, _teye(), W, H)
    return _bits(tpp.render_frame(ts, _teye(), TICK, w=W, h=H,
                                  per_pixel=per_pixel, shader_idx=5,
                                  backend="queue", raster_queue=q,
                                  show_cm=False))


@pytest.mark.parametrize("per_pixel", [False, True], ids=["V", "P"])
@pytest.mark.parametrize("layout", ["bands", "cyclic"])
def test_queue_bands_match_jax_and_one_rank(layout, per_pixel):
    """Each band's rows of the V and P frames, from its cached queue and
    rebuilt from the frame's setup (caps over CAP_EYES), equal JAX's
    sharded frames and the port's one-rank queue frame: 0 px."""
    _, ts = _scenes()
    want, want_moving = _jax_frames(layout, per_pixel)
    band_h = H // D
    queues = tshard.build_band_queues(ts, _teye(), w=W, h=H, n_dev=D,
                                      layout=layout)
    caps = tshard.band_queue_caps(ts, [torch.from_numpy(e) for e in CAP_EYES],
                                  w=W, h=H, n_dev=D, layout=layout)
    kw = dict(n_dev=D, w=W, h=H, per_pixel=per_pixel, shader_idx=5,
              layout=layout)
    for d in range(D):
        fb, stale = tshard.queue_band(ts, queues[d], _teye(), TICK, band=d,
                                      **kw)
        rows = slice(d * band_h, (d + 1) * band_h)
        assert not bool(stale)
        assert int((_bits(fb) != want[rows]).sum()) == 0, d
        fb, stale = tshard.queue_band(ts, None, _teye(), TICK, band=d,
                                      caps=caps, **kw)
        assert not bool(stale)
        assert int((_bits(fb) != want_moving[rows]).sum()) == 0, d
    frame = torch.from_numpy(want.copy())
    if layout == "cyclic":
        frame = tshard.deinterleave_rows(frame, D)
    assert int((frame.numpy() != _one_rank_frame(per_pixel)).sum()) == 0


def test_one_rank_group_is_the_whole_frame():
    """group=None: one band, no collective, the one-rank frame."""
    _, ts = _scenes()
    for layout in tshard.LAYOUTS:
        q = tshard.build_band_queues(ts, _teye(), w=W, h=H, n_dev=1,
                                     layout=layout)[0]
        fb, stale = tshard.make_sharded_queue_render(
            None, ts, _teye(), w=W, h=H, per_pixel=True, shader_idx=5,
            layout=layout)(ts, q, _teye(), TICK)
        assert not bool(stale)
        assert np.array_equal(_bits(fb), _one_rank_frame(True))


def test_queue_render_over_4_gloo_ranks():
    """4 spawned gloo ranks, each building only its band's queue (caps
    all-reduced with MAX): both layouts, V and P, cached and moving; every
    rank's gathered frame equals JAX's rank-major frame, and the caps the
    one-process caps."""
    _, ts = _scenes()
    inp = {"w": W, "h": H, "sphere": SPHERE, "eye": EYE, "tick": TICK,
           "cap_eyes": CAP_EYES}
    res = coll.spawn_ranks(torch_shard_ranks.raster, D, CPU, args=(inp,),
                           timeout=300)
    for layout in tshard.LAYOUTS:
        caps = tshard.band_queue_caps(ts, [_teye()], w=W, h=H, n_dev=D,
                                      layout=layout)
        for per_pixel in (False, True):
            tag = f"{layout}_{'P' if per_pixel else 'V'}"
            want, want_moving = _jax_frames(layout, per_pixel)
            for r in res:
                assert tuple(r[f"caps_{layout}"]) == caps
                assert not r[f"stale_{tag}"] and not r[f"moving_stale_{tag}"]
                assert int((r[f"queue_{tag}"] != want).sum()) == 0, tag
                assert int((r[f"moving_{tag}"] != want_moving).sum()) == 0

"""PyTorch port vs the JAX package: corner transform, triangle setup, the
flat-queue build (order="tri"), the plain versions of kernels B1 and B7,
and the queue frame's ray_world=False and defer=True forms.

Small shapes: mesh.make_sphere(16, 32) (1,024 triangles, the queue path)
at 128x128. Every kernel comparison is exact; z and the attribute planes
are compared under the coverage mask (outside it they are unspecified in
both packages). Frames are held within the repo's golden bound, 0.3% of
pixels (the ray_world unprojection is unsealed in JAX, ROADMAP C), and
the port's deferred frames to its own planes frames bit for bit.
Measured: 0 pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import stress_queue
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
from rustexp_tpu_torch.raster import structure as tstruct

W = H = 128
CPU = torch.device("cpu")
GOLDEN_FRAC = 0.003
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
    return _jit_setup(*xj[:3], W, H), tstruct.queue_setup(st, eye, W, H)


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


def test_duplicated_triangle_keeps_first_slot():
    """One triangle in two slots of one tile ties with itself on (z, tri)
    at every pixel it covers: the kernels' walk keeps the first slot, so
    the plain B1 and B7 give slot 0, as JAX's raster_zslot_queue (the
    Pallas kernel in interpret mode, tie=True) does on the same queue."""
    xs = np.array([[8.0], [120.0], [8.0]], np.float32)
    ys = np.array([[2.0], [2.0], [14.0]], np.float32)
    zs = np.full((3, 1), 0.5, np.float32)
    ids = np.full((1, trq.CHUNK), -1, np.int32)
    ids[0, :2] = 0
    scal = np.array([[0, 0, 1, 2, 0]], np.int32)
    extra = [np.array([1.0], np.float32), np.zeros(1, np.float32),
             np.zeros(1, np.float32)]

    setup = tpp.setup_triangles_planar(*map(torch.from_numpy, (xs, ys, zs)),
                                       W, 16)
    q = trq.Queue(torch.from_numpy(ids), torch.from_numpy(scal),
                  *[None] * 6, shade_w=trq.TILE_W)
    rows_i, rows_f = trq.gather_rows(
        q, trq.pack_table(setup, list(map(torch.from_numpy, extra))))
    z1, slot1, _ = trq.raster_attrs_queue_plain(q.scal, rows_i, rows_f,
                                                1, 0, 16, W)
    z7, slot7 = trq.raster_zslot_queue_plain(q.scal, rows_i, rows_f, 16, W)
    covered = slot1[:16] >= 0
    assert covered.sum() > 100
    assert torch.all(slot1[:16][covered] == 0)
    assert torch.equal(slot7, slot1) and torch.equal(z7[:16][covered],
                                                     z1[:16][covered])

    setj = _jit_setup(*map(jnp.asarray, (xs, ys, zs)), W, 16)
    qj = jrq.Queue(ids=jnp.asarray(ids), scal=jnp.asarray(scal),
                   ranges=jnp.zeros((1, 4), jnp.int32),
                   built_valid=jnp.ones(1, bool), overflow=jnp.asarray(False),
                   rows=jnp.zeros(1, jnp.int32),
                   ylim=jnp.asarray([[0, 16]], jnp.int32),
                   xlim=jnp.asarray([[0, W]], jnp.int32), shade_w=jrq.TILE_W)
    _, slotj, _, _ = jrq.raster_zslot_queue(
        qj, setj, tuple(map(jnp.asarray, extra)), 16, W)
    assert np.array_equal(np.asarray(slotj), slot7[:16].numpy())


def _permute_tiles(scal, ids, seed: int):
    """ids with the pairs of each tile shuffled across its chunks."""
    rng = np.random.default_rng(seed)
    ids = ids.copy()
    flat = ids.reshape(-1)
    c = 0
    while c < scal.shape[0]:
        e = c + 1
        while e < scal.shape[0] and scal[e, 2] == 0:
            e += 1
        slots = np.concatenate([k * trq.CHUNK + np.arange(scal[k, 3])
                                for k in range(c, e)])
        flat[slots] = flat[rng.permutation(slots)]
        c = e
    return ids


@pytest.mark.parametrize("eye_i", range(len(EYES)))
def test_b1_race_ignores_pair_order(scenes, eye_i):
    """The race is a lexicographic minimum over (z, tri), so its result
    does not depend on the order of a tile's pairs: with the pairs of
    every tile shuffled across its chunks, the port's plain B1 and JAX's
    raster_attrs_queue (interpret mode) give the same mask, z and planes,
    bit for bit under the mask, and the same winning triangle at every
    pixel as on the queue in its built order."""
    sj, st = scenes
    eye = EYES[eye_i]
    qj = jpp.build_scene_queue(sj, eye, W, H, per_pixel=True)
    leaves = {f: np.asarray(getattr(qj, f)) for f in qj._fields}
    scal = leaves["scal"]
    assert ((scal[:, 2] == 0) & (scal[:, 3] > 0)).any(), \
        "no tile holds two chunks"
    perm = _permute_tiles(scal, leaves["ids"], eye_i)
    assert not np.array_equal(perm, leaves["ids"])
    sett, extra, n2, n3 = tpp.queue_attr_channels(st, None, eye, W, H,
                                                  per_pixel=True)
    setj, _ = _setups(scenes, eye)
    extra_j = tuple(jnp.asarray(e.numpy()) for e in extra)
    got = []
    for ids in (leaves["ids"], perm):
        qj_ = qj._replace(ids=jnp.asarray(ids))
        qt = interop.queue_from_numpy({**leaves, "ids": ids}, CPU)
        zj, mj, lj, _ = jrq.raster_attrs_queue(qj_, setj, extra_j, n2, n3,
                                               H, W)
        zt, _, lt, _ = trq.raster_attrs_queue(qt, sett, extra, n2, n3, H, W)
        _, slot, _ = trq.raster_attrs_queue_plain(
            qt.scal, *trq.gather_rows(qt, trq.pack_table(sett, extra)),
            n2, n3, H, W)
        slot = slot[:H].numpy()
        won = np.where(slot >= 0, ids.reshape(-1)[np.maximum(slot, 0)], -1)
        got.append((np.asarray(mj), np.asarray(zj), np.stack(lj),
                    zt.numpy(), torch.stack(lt).numpy(), won))
    (mj, zj, lj, zt, lt, won), (mj2, zj2, lj2, zt2, lt2, won2) = got
    assert mj.sum() > 0 and np.array_equal(mj, mj2)
    assert np.array_equal(won, won2) and np.array_equal(won >= 0, mj)
    for a in (zj, zj2, zt, zt2):
        assert np.array_equal(a[mj].view(np.int32), zj[mj].view(np.int32))
    for a in (lj, lj2, lt, lt2):
        assert np.array_equal(a[:, mj].view(np.int32),
                              lj[:, mj].view(np.int32))


def _serial_walk(scal, rows_i, rows_f, n2, n3, h, w):
    """The kernels' walk written out in numpy: each tile's pairs in queue
    order, a fragment kept when (z, tri) < (z_cur, tri_cur), from the
    clear (1.0, INT32_MAX); each op rounds once, ints wrap."""
    hp = h + trq.TILE_H
    z = np.ones((hp, w), np.float32)
    tri = np.full((hp, w), trq.INT32_MAX, np.int64)
    slot = np.full((hp, w), -1, np.int32)
    lin = np.zeros((n2 + n3, hp, w), np.float32)
    iy, ix = np.mgrid[:trq.TILE_H, :trq.TILE_W].astype(np.int32)
    with np.errstate(over="ignore"):
        for c in range(scal.shape[0]):
            ty, tx, _, cnt, gty = scal[c]
            xs, ys = tx * trq.TILE_W + ix, gty * trq.TILE_H + iy
            out = np.s_[ty * trq.TILE_H:(ty + 1) * trq.TILE_H,
                        tx * trq.TILE_W:(tx + 1) * trq.TILE_W]
            for p in range(min(max(cnt, 0), trq.CHUNK)):
                ci, cf = rows_i[c, :, p], rows_f[c, :, p]
                e0 = ci[0] * (xs << 4) + ci[2] * (ys << 4) + ci[4]
                e1 = ci[1] * (xs << 4) + ci[3] * (ys << 4) + ci[5]
                e2 = ci[6] - e0 - e1
                cov = (((e0 | e1 | e2) >= 0) & (xs >= ci[7]) & (ys >= ci[8])
                       & (xs < ci[9]) & (ys < ci[10]))
                b0, b1, b2 = ((e - np.int32(cf[k])).astype(np.float32) * cf[6]
                              for k, e in enumerate((e0, e1, e2)))
                zm = np.where(cov, cf[3] + cf[4] * b2 + cf[5] * b0, np.inf)
                up = (zm < z[out]) | ((zm == z[out]) & (ci[11] < tri[out]))
                z[out][up], tri[out][up] = zm[up], ci[11]
                slot[out][up] = c * trq.CHUNK + p
                f = cf[trq._F_CH:]
                for a in range(n2):
                    v = f[a] + f[n2 + a] * b2 + f[2 * n2 + a] * b0
                    lin[a][out][up] = v[up]
                for a in range(n3):
                    g = f[3 * n2:]
                    v = g[a] * b1 + g[n3 + a] * b2 + g[2 * n3 + a] * b0
                    lin[n2 + a][out][up] = v[up]
    return z, slot, lin


@pytest.mark.parametrize("n2,n3", trq._B1_PLANES)
def test_b1_plain_matches_serial_walk_on_stress_queue(n2, n3):
    """The plain B1 and B7 on the stress queue (chip_smoke.stress_queue: 16
    chunks in one tile; copies of a triangle under other ids tying at
    z == 1.0 and at -0.0/+0.0; one id in two slots; a tile of empty
    chunks) against the serial walk: slot everywhere, z and planes bit
    for bit under slot >= 0."""
    scal, rows_i, rows_f, h, w = stress_queue(n2, n3, CPU)
    z, slot, lin = trq.raster_attrs_queue_plain(scal, rows_i, rows_f,
                                                n2, n3, h, w)
    z7, slot7 = trq.raster_zslot_queue_plain(scal, rows_i, rows_f, h, w)
    zw, slotw, linw = _serial_walk(scal.numpy(), rows_i.numpy(),
                                   rows_f.numpy(), n2, n3, h, w)
    won = slotw >= 0
    assert np.array_equal(slot.numpy(), slotw)
    assert np.array_equal(slot7.numpy(), slotw)
    for got in (z, z7):
        assert np.array_equal(got.numpy()[won].view(np.int32),
                              zw[won].view(np.int32))
    assert np.array_equal(lin.numpy()[:, won].view(np.int32),
                          linw[:, won].view(np.int32))
    zb = zw[won].view(np.int32)
    assert (zw[won] == 1.0).sum() > 100       # ties at 1.0 beat the clear
    assert (zb == np.int32(-2**31)).sum() > 100   # the lowest id's -0.0
    assert not won[:, trq.TILE_W:].any()      # the tile of empty chunks


@pytest.mark.parametrize("per_pixel", [False, True])
def test_b7_plain_matches_jax_kernel(scenes, per_pixel):
    """The plain version of B7 on a JAX-built queue (interop) against JAX
    raster_zslot_queue, which runs _queue_kernel_zslot in interpret mode
    here: slot everywhere, z under slot >= 0 (z is unwritten in tiles no
    chunk visits), and the slot-indexed channel table bit for bit."""
    sj, st = scenes
    eye = EYES[2]
    qj = jpp.build_scene_queue(sj, eye, W, H, per_pixel=per_pixel)
    qt = interop.queue_from_numpy(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, CPU)
    colors = None if per_pixel else tpp.vertex_colors(st, eye, 0.0, W, H, 5)
    sett, extra, _, _ = tpp.queue_attr_channels(st, colors, eye, W, H,
                                                per_pixel=per_pixel)
    setj, _ = _setups(scenes, eye)
    zj, slj, fj, stj = jrq.raster_zslot_queue(
        qj, setj, tuple(jnp.asarray(e.numpy()) for e in extra), H, W)
    zt, slt, ft, stt = trq.raster_zslot_queue(qt, sett, extra, H, W)
    slj = np.asarray(slj)
    won = slj >= 0
    assert won.sum() > 0 and np.array_equal(slt.numpy(), slj)
    assert np.array_equal(np.asarray(zj)[won].view(np.int32),
                          zt.numpy()[won].view(np.int32))
    assert np.array_equal(np.asarray(fj).view(np.int32),
                          ft.numpy().view(np.int32))
    assert bool(stj) == bool(stt) is False


def test_b7_plain_race_tie_break():
    """B7's plain race is B1's: the lower triangle id wins a z tie in
    either queue order, and a fragment at exactly z == 1.0 beats the
    depth clear (the INT32_MAX tie-scratch quirk, ROADMAP C); its z and
    slot equal the plain B1's."""
    xs = torch.tensor([[8.0, 8.0], [120.0, 120.0], [8.0, 8.0]])
    ys = torch.tensor([[2.0, 2.0], [2.0, 2.0], [14.0, 14.0]])
    setup = tpp.setup_triangles_planar(xs, ys, torch.ones((3, 2)), W, 16)
    tab = trq.pack_table(setup, [torch.tensor([1.0, 2.0]), torch.zeros(2),
                                 torch.zeros(2)])
    for order in ([0, 1], [1, 0]):
        ids = torch.full((1, trq.CHUNK), -1, dtype=torch.int32)
        ids[0, :2] = torch.tensor(order)
        scal = torch.tensor([[0, 0, 1, 2, 0]], dtype=torch.int32)
        q = trq.Queue(ids, scal, *[None] * 6, shade_w=trq.TILE_W)
        rows_i, rows_f = trq.gather_rows(q, tab)
        z, slot = trq.raster_zslot_queue_plain(scal, rows_i, rows_f, 16, W)
        z1, slot1, _ = trq.raster_attrs_queue_plain(scal, rows_i, rows_f,
                                                    1, 0, 16, W)
        covered = slot[:16] >= 0
        assert covered.sum() > 100
        assert torch.all(z[:16][covered] == 1.0)
        assert torch.all(slot[:16][covered] == order.index(0))
        assert torch.equal(slot, slot1) and torch.equal(z, z1)


def _unvisited_tiles(scal, h: int, w: int) -> list:
    """(ty, tx) of every tile of the h + TILE_H-row frame that no chunk of
    scal names."""
    seen = {(int(ty), int(tx)) for ty, tx in scal[:, :2].tolist()}
    return [(ty, tx) for ty in range(h // trq.TILE_H + 1)
            for tx in range(w // trq.TILE_W) if (ty, tx) not in seen]


@pytest.mark.parametrize("case", ["V", "P", "stress"])
def test_b7_plain_equals_b1_plain_race(scenes, case):
    """B7's contract on every word: its plain (z, slot) equal the plain
    B1's bit for bit over the whole h + TILE_H-row frame, the clear (z
    1.0, slot -1) wherever nothing won, in a tile that no chunk visits and
    in the pad row: on the procedural scene's queue (V and P) and on the
    stress queue (chip_smoke.stress_queue), whose pad row holds a tile no
    chunk visits."""
    if case == "stress":
        scal, rows_i, rows_f, h, w = stress_queue(4, 0, CPU)
        n2, n3 = 4, 0
    else:
        _, st = scenes
        eye = camera.cam_orbit(0.7)
        per_pixel = case == "P"
        q = tstruct.build(st, tstruct.QUEUE, eye, W, H,
                          per_pixel=per_pixel).data
        colors = None if per_pixel else tpp.vertex_colors(st, eye, 0.0, W, H,
                                                          5)
        sett, extra, n2, n3 = tpp.queue_attr_channels(st, colors, eye, W, H,
                                                      per_pixel=per_pixel)
        rows_i, rows_f = trq.gather_rows(q, trq.pack_table(sett, extra))
        scal, h, w = q.scal, H, W
    z1, slot1, _ = trq.raster_attrs_queue_plain(scal, rows_i, rows_f,
                                                n2, n3, h, w)
    z7, slot7 = trq.raster_zslot_queue_plain(scal, rows_i, rows_f, h, w)
    assert z7.shape == slot7.shape == (h + trq.TILE_H, w)
    assert torch.equal(slot7, slot1)
    assert torch.equal(z7.view(torch.int32), z1.view(torch.int32))
    lost = slot7 < 0
    assert (~lost).sum() > 100 and lost.sum() > 100
    assert torch.all(z7[lost] == 1.0)
    assert torch.all(lost[h:]) and torch.all(z7[h:] == 1.0)  # the pad row
    unvisited = _unvisited_tiles(scal, h, w)
    assert unvisited
    for ty, tx in unvisited:
        tile = np.s_[ty * trq.TILE_H:(ty + 1) * trq.TILE_H,
                     tx * trq.TILE_W:(tx + 1) * trq.TILE_W]
        assert torch.all(slot7[tile] == -1) and torch.all(z7[tile] == 1.0)


@pytest.mark.parametrize("eye_i", range(len(EYES)))
def test_b7_race_ignores_pair_order(scenes, eye_i):
    """B7's race, like B1's, is a lexicographic minimum over (z, tri):
    with the pairs of every tile shuffled across its chunks, the port's
    plain B7 and JAX's raster_zslot_queue (interpret mode) give the same
    winning triangle at every pixel, and the same z bit for bit under
    slot >= 0, as on the queue in its built order."""
    sj, st = scenes
    eye = EYES[eye_i]
    qj = jpp.build_scene_queue(sj, eye, W, H, per_pixel=True)
    leaves = {f: np.asarray(getattr(qj, f)) for f in qj._fields}
    scal = leaves["scal"]
    assert ((scal[:, 2] == 0) & (scal[:, 3] > 0)).any(), \
        "no tile holds two chunks"
    perm = _permute_tiles(scal, leaves["ids"], eye_i)
    assert not np.array_equal(perm, leaves["ids"])
    sett, extra, _, _ = tpp.queue_attr_channels(st, None, eye, W, H,
                                                per_pixel=True)
    setj, _ = _setups(scenes, eye)
    extra_j = tuple(jnp.asarray(e.numpy()) for e in extra)
    got = []
    for ids in (leaves["ids"], perm):
        zj, slj, _, _ = jrq.raster_zslot_queue(
            qj._replace(ids=jnp.asarray(ids)), setj, extra_j, H, W)
        qt = interop.queue_from_numpy({**leaves, "ids": ids}, CPU)
        zt, slt = trq.raster_zslot_queue_plain(
            qt.scal, *trq.gather_rows(qt, trq.pack_table(sett, extra)), H, W)
        for z, slot in ((np.asarray(zj), np.asarray(slj)),
                        (zt[:H].numpy(), slt[:H].numpy())):
            won = np.where(slot >= 0, ids.reshape(-1)[np.maximum(slot, 0)],
                           -1)
            got.append((won, z))
    won, z = got[0]
    mask = won >= 0
    assert mask.sum() > 0
    for won_, z_ in got[1:]:
        assert np.array_equal(won_, won)
        assert np.array_equal(z_[mask].view(np.int32), z[mask].view(np.int32))


def _queue_frames(scenes, eye, per_pixel, **kw):
    """(JAX frame, port frame) of raster_and_shade_queue with `kw`, each
    package on its own queue."""
    sj, st = scenes
    ej = jnp.asarray(eye)
    colors_j = colors_t = None
    if not per_pixel:
        _, world, n_world = jpp.transform_vertices(sj, ej, W, H)
        colors_j = jpp.sh.shader_fn(5)(world, n_world, sj.colors, ej,
                                       jnp.float32(0.7), sj.cm)
        colors_t = tpp.vertex_colors(st, eye, 0.7, W, H, 5)
    qj = jpp.build_scene_queue(sj, ej, W, H, per_pixel=per_pixel)
    qt = tstruct.build(st, tstruct.QUEUE, eye, W, H, per_pixel=per_pixel).data
    fj, sj_ = jpp.raster_and_shade_queue(
        sj, qj, colors_j, ej, jnp.float32(0.7), w=W, h=H,
        per_pixel=per_pixel, shader_idx=5, bg_fb=jpp.background(0, W, H),
        **kw)
    ft, st_ = tpp.raster_and_shade_queue(
        st, qt, colors_t, eye, 0.7, w=W, h=H, per_pixel=per_pixel,
        shader_idx=5, bg_fb=tpp.background(0, W, H, CPU), **kw)
    assert bool(sj_) == bool(st_) is False
    return np.asarray(fj), ft.view(torch.uint32)


@pytest.mark.parametrize("per_pixel,ray_world", [(False, True), (True, True),
                                                 (True, False)])
def test_queue_defer_matches_planes_and_jax(scenes, per_pixel, ray_world):
    """defer=True (B7's race, then _shade_deferred re-evaluates each
    winner) equals the planes path (defer=False) bit for bit, as JAX pins
    (tests/test_raster.py:563), and JAX's defer=True frame within the
    golden bound."""
    eye = EYES[0]
    want, got = _queue_frames(scenes, eye, per_pixel, ray_world=ray_world,
                              defer=True)
    _, planes = _queue_frames(scenes, eye, per_pixel, ray_world=ray_world)
    assert torch.equal(got, planes)
    assert int((want != got.numpy()).sum()) <= GOLDEN_FRAC * W * H
    bg = np.asarray(jpp.background(0, W, H))
    assert (want != bg).sum() > W * H // 10


def test_queue_ray_world_false_matches_jax(scenes):
    """ray_world=False: world positions interpolated as three more planes
    (B1's (4, 6) form) instead of unprojected; P frame against JAX's, and
    its planes against JAX's kernel (interpret mode) bit for bit."""
    sj, st = scenes
    eye = EYES[2]
    want, got = _queue_frames(scenes, eye, True, ray_world=False)
    assert int((want != got.numpy()).sum()) <= GOLDEN_FRAC * W * H
    qj = jpp.build_scene_queue(sj, eye, W, H)
    qt = interop.queue_from_numpy(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, CPU)
    sett, extra, n2, n3 = tpp.queue_attr_channels(
        st, None, eye, W, H, per_pixel=True, ray_world=False)
    assert (n2, n3) == (4, 6) and (n2, n3) in trq._B1_PLANES
    setj, _ = _setups(scenes, eye)
    zj, mj, lj, _ = jrq.raster_attrs_queue(
        qj, setj, tuple(jnp.asarray(e.numpy()) for e in extra), n2, n3, H, W)
    zt, mt, lt, _ = trq.raster_attrs_queue(qt, sett, extra, n2, n3, H, W)
    mj = np.asarray(mj)
    assert mj.sum() > 0 and np.array_equal(mt.numpy(), mj)
    for a, b in zip(lj, lt):
        assert np.array_equal(np.asarray(a)[mj].view(np.int32),
                              b.numpy()[mj].view(np.int32))

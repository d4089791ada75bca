"""PyTorch port vs the JAX package: the bins path (backend="pallas").

Triangle setup from per-vertex viewport coordinates, the [nT, cap] bins
(bin_triangles, bin_pairs), the plain version of kernel B2 against the
Pallas kernel in interpret mode, suggest_binning, whole frames, the golden
raster_sphere_cmrefl_p frame and the Experiment's small-mesh route.

Small shapes: make_sphere(12, 24) (576 triangles) and the 12-triangle
cube at 128x128. Setup, bins and the raster are compared bit for bit;
frames within 0.3% of pixels, the repo's golden bound (tests/test_golden.py).
Measured on this suite: 0 pixels (ROADMAP C).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.ops import raster_pallas as jrp
from rustexp_tpu.ops import raster_setup as jrs
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.sims.rasterizer import RasterizerExperiment as JaxExperiment
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.ops import raster_bins as trb
from rustexp_tpu_torch.ops import raster_setup as trs
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import structure as tstruct
from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

W = H = 128
CPU = torch.device("cpu")
GOLDEN_FRAC = 0.003
EYES = (camera.cam_orbit(0.7), camera.cam_orbit_front(1.3),
        camera.cam_pan_front(0.2))
MESHES = {"sphere": lambda: jmesh.make_sphere(12, 24), "cube": jmesh.make_cube}


@pytest.fixture(scope="module", params=sorted(MESHES))
def scenes(request):
    m = MESHES[request.param]()
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))


@pytest.fixture(scope="module")
def sphere():
    m = jmesh.make_sphere(12, 24)
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))


_jit_vertices = jax.jit(jpp.transform_vertices, static_argnums=(2, 3))
_jit_setup = jax.jit(jrs.setup_triangles, static_argnums=(2, 3))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tuple_equal(a, b, what):
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape, f"{what}.{f}: {x.shape} vs {y.shape}"
        assert x.dtype == y.dtype, f"{what}.{f}: {x.dtype} vs {y.dtype}"
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), f"{what}.{f}"


def _setups(sj, st, eye):
    vj, _, _ = _jit_vertices(sj, jnp.asarray(eye), W, H)
    vt, _, _ = tpp.transform_vertices(st, eye, W, H)
    return _jit_setup(vj, sj.tris, W, H), trs.setup_triangles(vt, st.tris, W, H)


def _extra(n_tris, n_ch, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_tris, n_ch)).astype(np.float32)


def _diff(a, b) -> int:
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint32
    return int((a != b).sum())


@pytest.mark.parametrize("eye_i", range(len(EYES)))
def test_setup_triangles_matches_jax(scenes, eye_i):
    """Bit for bit, and equal to the planar form's to_trisetup()."""
    sj, st = scenes
    setj, sett = _setups(sj, st, EYES[eye_i])
    _assert_tuple_equal(setj, sett, "TriSetup")
    planar = tstruct.queue_setup(st, EYES[eye_i], W, H).to_trisetup()
    _assert_tuple_equal(sett, planar, "to_trisetup")
    assert bool(sett.valid.any())


# At EYES[0] the sphere's widest front-facing triangle spans 1 x 2 of the
# 32x128 tiles (x, y) and its largest bin holds 113 triangles
@pytest.mark.parametrize("kind,cap,spans,overflows", [
    ("triangles", 1024, None, False),    # T < cap: zero-padded slots
    ("triangles", 256, None, False),
    ("triangles", 8, None, True),        # over capacity
    ("pairs", 256, (2, 3), False),
    ("pairs", 8, (2, 3), True),          # over capacity
    ("pairs", 256, (1, 1), True),        # over the span budget
])
def test_bins_match_jax(sphere, kind, cap, spans, overflows):
    """Every leaf, the contents of empty slots and overflow included."""
    sj, st = sphere
    setj, sett = _setups(sj, st, EYES[0])
    extra = _extra(setj.A.shape[0], 3 * 4)
    if kind == "triangles":
        bj = jrp.bin_triangles(setj, H, W, cap, extra_f=jnp.asarray(extra))
        bt = trb.bin_triangles(sett, H, W, cap, extra_f=torch.from_numpy(extra))
    else:
        bj = jrp.bin_pairs(setj, H, W, cap, *spans, extra_f=jnp.asarray(extra))
        bt = trb.bin_pairs(sett, H, W, cap, *spans,
                           extra_f=torch.from_numpy(extra))
    _assert_tuple_equal(bj, bt, "BinnedTris")
    assert bool(bt.overflow) is overflows
    assert int(bt.counts.sum()) > 0


def test_bin_stats_match_jax(scenes):
    sj, st = scenes
    for eye in EYES:
        setj, sett = _setups(sj, st, eye)
        assert int(trb.max_bin_count(sett, H, W)) == int(
            jrp.max_bin_count(setj, H, W))
        assert tuple(map(int, trb.max_spans(sett, H, W))) == tuple(
            map(int, jrp.max_spans(setj, H, W)))
        for w, h in ((W, H), (256, 128)):
            assert tstruct.suggest_binning(st, eye, w, h) == \
                jpp.suggest_binning(sj, eye, w, h)


def _attr_inputs(sj, st, eye, per_pixel):
    """(setup_j, setup_t, extra_j, extra_t, n2, n3) of the real frame."""
    vt, wt, nt = tpp.transform_vertices(st, eye, W, H)
    colors = st.colors if per_pixel else tpp.vertex_colors(st, eye, 0.0,
                                                           W, H, 5)
    extra, n2, n3 = tpp.bins_attr_channels(st, vt, wt, nt, colors,
                                           per_pixel=per_pixel)
    setj, sett = _setups(sj, st, eye)
    return setj, sett, jnp.asarray(extra.numpy()), extra, n2, n3


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("spans", [None, (3, 3)])
def test_b2_plain_matches_jax_kernel(sphere, per_pixel, spans):
    """raster_attrs_bins (plain B2 on CPU) against raster_attrs_pallas,
    which runs the Pallas kernel in interpret mode here: z, mask and
    every plane over the whole frame, on the port's own bins and then on
    JAX's bins carried over by interop.bins_from_numpy."""
    sj, st = sphere
    eye = EYES[1]
    setj, sett, extj, extt, n2, n3 = _attr_inputs(sj, st, eye, per_pixel)
    cap = None if spans is None else 256
    zj, mj, lj, oj = jrp.raster_attrs_pallas(setj, extj, n2, n3, H, W,
                                             cap=cap, spans=spans)
    zt, mt, lt, ot = trb.raster_attrs_bins(sett, extt, n2, n3, H, W,
                                           cap=cap, spans=spans)
    mj = np.asarray(mj)
    assert 0 < mj.sum() < W * H and np.array_equal(mt.numpy(), mj)
    assert np.array_equal(np.asarray(zj).view(np.int32),
                          zt.numpy().view(np.int32))
    assert len(lt) == len(lj) == n2 + n3
    for a, b in zip(lj, lt):
        assert np.array_equal(np.asarray(a).view(np.int32),
                              b.numpy().view(np.int32))
    assert bool(oj) == bool(ot) is False

    # JAX's bins, carried into the port, through the plain version
    bt = trb.make_bins(sett, extt, n2, n3, H, W, cap=cap, spans=spans)
    k = bt.setup_i.shape[1]
    if spans is None:
        bj = jrp.bin_triangles(setj, H, W, k, extra_f=extj)
    else:
        bj = jrp.bin_pairs(setj, H, W, k, *spans, extra_f=extj)
    carried = interop.bins_from_numpy(
        {f: np.asarray(getattr(bj, f)) for f in bj._fields}, CPU)
    _assert_tuple_equal(carried, bt, "carried bins")
    z, slot, lin = trb.raster_attrs_bins_plain(
        carried.counts, carried.setup_i, carried.setup_f, n2, n3, H, W)
    assert np.array_equal((slot >= 0).numpy(), mj)
    assert torch.equal(z.view(torch.int32), zt.view(torch.int32))
    assert torch.equal(lin.view(torch.int32),
                       torch.stack(lt).view(torch.int32))


def test_b2_plain_strict_depth_race():
    """Two coplanar copies of one triangle tie on z at every pixel: the
    earlier bin slot wins (strict z <, as the Pallas kernel). A third
    triangle at z = 1.0 never beats the depth clear."""
    v = np.array([[[8.0, 2.0, 0.5, 1.0], [120.0, 2.0, 0.5, 1.0],
                   [8.0, 30.0, 0.5, 1.0]]], np.float32)
    corners = np.concatenate([v, v, v], axis=0)     # [3 tris, 3 corners, 4]
    corners[2, :, 2] = 1.0
    extra = np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0], [3.0, 0.0, 0.0]],
                     np.float32)                    # plane = triangle's value
    vt = [torch.from_numpy(corners[:, j]) for j in range(3)]
    sett = trs.setup_triangles_v(*vt, W, 32)
    z, mask, lin, overflow = trb.raster_attrs_bins(
        sett, torch.from_numpy(extra), 1, 0, 32, W)
    assert not bool(overflow) and mask.sum() > 1000
    assert torch.all(z[mask] == 0.5)
    assert torch.all(lin[0][mask] == 1.0)           # slot 0 (triangle 0)
    setj = jrs.setup_triangles_v(*[jnp.asarray(c.numpy()) for c in vt], W, 32)
    zj, mj, lj, _ = jrp.raster_attrs_pallas(setj, jnp.asarray(extra), 1, 0,
                                            32, W)
    assert np.array_equal(np.asarray(mj), mask.numpy())
    assert np.array_equal(np.asarray(lj[0]), lin[0].numpy())
    assert np.array_equal(np.asarray(zj), z.numpy())


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("rows", [None, 256, 96])
def test_render_frame_pallas_matches_jax(sphere, per_pixel, rows):
    """backend="pallas" frames, full-frame shade (rows None) and the
    compacted shade over occupied 64-px blocks (raster_rows): 256 holds
    every block of the frame, 96 is too few and raises overflow in both."""
    sj, st = sphere
    eye = EYES[0]
    cap, spans, _ = tstruct.suggest_binning(st, eye, W, H)
    kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=5,
              return_overflow=True)
    want, oj = jpp.render_frame(sj, jnp.asarray(eye), 0.7, backend="pallas",
                                raster_cap=cap, raster_spans=spans,
                                raster_rows=rows, **kw)
    got, ot = tpp.render_frame(st, eye, 0.7, structure=tstruct.Structure(
        tstruct.BINS, (cap, spans, rows)), **kw)
    assert _diff(want, got) <= GOLDEN_FRAC * W * H
    assert bool(ot) == bool(oj) == (per_pixel and rows == 96)
    bg = np.asarray(jpp.background(0, W, H))
    assert (np.asarray(want) != bg).sum() > W * H // 10


@pytest.mark.parametrize("backend", ["auto", "queue"])
def test_auto_takes_the_bins_on_tileable_frames(sphere, backend):
    """Without a prebuilt queue, JAX's "auto" and "queue" take the bins
    with the default (dense, capacity T) binning, and so does the port's
    render_frame without a structure."""
    sj, st = sphere
    eye = EYES[2]
    kw = dict(w=W, h=H, per_pixel=True, shader_idx=5)
    want = jpp.render_frame(sj, jnp.asarray(eye), 0.2, backend=backend, **kw)
    got = tpp.render_frame(st, eye, 0.2, **kw)
    assert _diff(want, got) <= GOLDEN_FRAC * W * H
    assert torch.equal(got, tpp.render_frame(
        st, eye, 0.2, structure=tstruct.Structure(tstruct.BINS), **kw))


def test_golden_raster_sphere_cmrefl_p(sphere):
    """The port's frame against the JAX package's stored golden
    (tests/test_golden.py::test_golden_raster_cmrefl_pixel)."""
    _, st = sphere
    fb = tpp.render_frame(st, camera.cam_orbit(0.5), 0.5, w=W, h=H,
                          per_pixel=True, shader_idx=5, bg_idx=1,
                          show_cm=True,
                          structure=tstruct.Structure(tstruct.BINS))
    want = np.load("tests/goldens/raster_sphere_cmrefl_p.npz")["fb"]
    assert _diff(want, fb) <= GOLDEN_FRAC * W * H


@pytest.mark.parametrize("per_pixel", [False, True])
def test_experiment_cube_matches_jax(per_pixel):
    """Cube (mesh 9, 12 triangles) takes the bins route in both
    Experiments; two ticks, the second on the cached binning config."""
    je, te = JaxExperiment(), RasterizerExperiment(CPU)
    js, ts = (je.init(mesh_idx=9, per_pixel=per_pixel),
              te.init(mesh_idx=9, per_pixel=per_pixel))
    for tick in (0.0, 0.05):
        want = je.render(js, W, H, tick)
        got = te.render(ts, W, H, tick)
        assert _diff(want, got) <= GOLDEN_FRAC * W * H
    assert ts._scene_cache[2][0] == js._scene_cache[2][0] == "pallas"
    assert ts._scene_cache[2][1] == js._scene_cache[2][1]
    assert te.status(ts).split("| ", 2)[2] == je.status(js).split("| ", 2)[2]

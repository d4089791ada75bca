"""PyTorch port vs the JAX package: the point and line render modes and the
rasterizer experiment's keys (ROADMAP A10).

Point and line frames are compared at 0 differing pixels, except for the
port's order-free rule at pixel (0, 0) (test_zero_pixel_rule; ROADMAP C),
and the port's wireframe against the stored golden within the golden's
0.3%. The keys are held against the JAX experiment's state after the
same keys.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.sims.rasterizer import RasterizerExperiment as JaxExperiment
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.assets import mesh as tmesh
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import structure as tstruct
from rustexp_tpu_torch.raster import shaders as tsh
from rustexp_tpu_torch.sims import rasterizer as trast

CPU = torch.device("cpu")
WHITE = 0x00FFFFFF
GOLDEN = "tests/goldens/raster_sphere_wire.npz"


@pytest.fixture(scope="module")
def sphere():
    """The 128^2 golden's sphere (tests/test_golden.py raster_scene)."""
    m = jmesh.make_sphere(12, 24)
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(tmesh.make_sphere(12, 24),
                           tcubemap.make_procedural_set(), CPU))


@pytest.mark.parametrize("mode", [jpp.MODE_POINT, jpp.MODE_LINE])
@pytest.mark.parametrize("eye_fn,tick", [(camera.cam_pan_front, 0.2),
                                         (camera.cam_orbit, 0.5),
                                         (camera.cam_orbit_front, 1.3)])
def test_sphere_modes_match_jax(sphere, mode, eye_fn, tick):
    sj, st = sphere
    eye = eye_fn(tick)
    kw = dict(w=128, h=128, mode=mode, shader_idx=0, bg_idx=4, show_cm=False)
    want = np.asarray(jpp.render_frame(sj, jnp.asarray(eye), tick, **kw))
    got, overflow = tpp.render_frame(st, eye, tick, return_overflow=True,
                                     **kw)
    assert got.dtype == torch.uint32 and overflow.dtype == torch.bool
    assert not bool(overflow) and overflow.device == CPU
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          want)
    assert int((got.view(torch.int32) == WHITE).sum()) > 100


@pytest.mark.parametrize("mode", [jpp.MODE_POINT, jpp.MODE_LINE])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_killeroo_modes_match_jax(mode, per_pixel):
    """Procedural Killeroo at 128x96 with shader 5's cubemap cross, the
    structure of every backend name: the modes read no structure and run
    no shader."""
    m = jmesh.get_mesh(0)
    sj = jpp.make_scene(m, jcubemap.get_cm_set(0))
    st = tpp.make_scene(tmesh.get_mesh(0), tcubemap.get_cm_set(0), CPU)
    eye = camera.camera_eye(jmesh.mesh_camera(0), 0.4)
    kw = dict(w=128, h=96, mode=mode, per_pixel=per_pixel, shader_idx=5)
    want = np.asarray(jpp.render_frame(sj, jnp.asarray(eye), 0.4, **kw))
    for backend in tstruct.BACKENDS:
        kind = tstruct.route(m.num_tris, 128, 96, backend)
        got = tpp.render_frame(st, eye, 0.4,
                               structure=tstruct.Structure(kind), **kw)
        assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                              want), backend


def test_wireframe_golden(sphere):
    """The port's line frame against raster_sphere_wire.npz within the
    golden's 0.3% (tests/test_golden.py test_golden_raster_wireframe)."""
    _, st = sphere
    got = tpp.render_frame(st, camera.cam_pan_front(0.2), 0.2, w=128, h=128,
                           mode=tpp.MODE_LINE, shader_idx=0, bg_idx=4,
                           show_cm=False)
    want = np.load(GOLDEN)["fb"]
    diff = int((got.view(torch.int32).numpy().view(np.uint32) != want).sum())
    assert diff <= 0.003 * 128 * 128, diff


def _draw(pkg_fn, fb, vp, tris):
    return pkg_fn(torch.from_numpy(fb.view(np.int32)), torch.from_numpy(vp),
                  torch.from_numpy(tris), 32, 32).numpy().view(np.uint32)


def _jax_draw(name, fb, vp, tris):
    fn = jax.jit(getattr(jpp, name), static_argnums=(3, 4))
    return np.array(fn(jnp.asarray(fb), vp, tris, 32, 32))


@pytest.mark.parametrize("name", ["draw_points", "draw_lines"])
def test_zero_pixel_rule(name):
    """A triangle with a corner at (0.5, 0.5): its points and edges hit
    pixel (0, 0). JAX also sends every dead sample there with that
    pixel's old value, so its (0, 0) follows the scatter's order (XLA:CPU:
    the old value). The port writes live samples only: (0, 0) is white,
    and every other pixel is JAX's."""
    vp = np.array([[0.5, 0.5, 0.5, 1], [20.5, 10.5, 0.5, 1],
                   [5.5, 30.5, 0.5, 1], [40.0, 40.0, 0.5, 1]], np.float32)
    tris = np.array([[0, 1, 2], [3, 3, 3]], np.int32)
    fb = np.full((32, 32), 0x123456, np.uint32)
    got = _draw(getattr(tpp, name), fb, vp, tris)
    want = _jax_draw(name, fb, vp, tris)
    assert got[0, 0] == WHITE
    want[0, 0] = WHITE
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["draw_points", "draw_lines"])
def test_float_to_int_cases_match_jax(name):
    """Vertices at NaN, +-inf, 3e9, -0.5 and -0.99: XLA's convert
    saturates and sends NaN to 0 (so a NaN x paints column 0), and
    truncates -0.5 to 0; the port's trunc_i32 gives the same pixels on
    every device. No sample reaches (0, 0)."""
    vp = np.array([[np.nan, 5.0, 0, 1], [np.inf, 6.0, 0, 1],
                   [-np.inf, 7.0, 0, 1], [3e9, 8.0, 0, 1], [-0.5, 9.0, 0, 1],
                   [31.99, -0.99, 0, 1], [5.0, 3e9, 0, 1],
                   [7.5, np.nan, 0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5], [6, 4, 0], [7, 5, 4]], np.int32)
    fb = np.full((32, 32), 0x654321, np.uint32)
    got = _draw(getattr(tpp, name), fb, vp, tris)
    want = _jax_draw(name, fb, vp, tris)
    assert np.array_equal(got, want) and got[0, 0] != WHITE
    if name == "draw_points":  # the NaN x and the -0.5 x: column 0
        assert got[5, 0] == WHITE and got[9, 0] == WHITE


def test_key_table_matches_jax():
    """Every key, pressed more times than its field has values (each
    wraps), then a mixed sequence: the port's state equals JAX's after
    the same keys; unknown keys change nothing."""
    fields = ("mode", "per_pixel", "mesh_idx", "shader_idx", "env_idx",
              "bg_idx")
    je, te = JaxExperiment(), trast.RasterizerExperiment(CPU)
    for key in "MPQWASZX12mpqwaszx":
        js, ts = je.init(), te.init()
        for i in range(20):
            js, ts = je.handle_key(js, key), te.handle_key(ts, key)
            want = tuple(getattr(js, f) for f in fields)
            assert tuple(getattr(ts, f) for f in fields) == want, (key, i)
    js, ts = je.init(), te.init()
    for key in "QQQAMmPZX2211?!\x1b":
        js, ts = je.handle_key(js, key), te.handle_key(ts, key)
    assert tuple(getattr(ts, f) for f in fields) == tuple(
        getattr(js, f) for f in fields)
    assert (ts.mesh_idx, ts.shader_idx, ts.mode) == (9, 4, 1)


def test_b_key_runs_the_suite_on_the_experiment_device(monkeypatch):
    from rustexp_tpu_torch.app import benchmark as tbench

    calls = []
    monkeypatch.setattr(tbench, "run_suite",
                        lambda runs, device: calls.append((runs, device)))
    te = trast.RasterizerExperiment(CPU)
    ts = te.init()
    assert te.handle_key(ts, "b") is ts
    assert calls == [(20, CPU)]


def test_experiment_defaults_to_the_card(monkeypatch):
    """RasterizerExperiment() is the card, as GoL's and N-body's are, and
    raises without one; the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trast.RasterizerExperiment()
    assert trast.RasterizerExperiment("cpu").device == CPU


@pytest.mark.parametrize("mesh_idx", range(tmesh.NUM_MESHES))
def test_keys_reach_configs_that_render(mesh_idx):
    """From the defaults, W keys walk to the mesh; then every shader (S)
    in Fill, and the point and line modes (M), render at 64x64 without
    raising, per-vertex, and per-pixel on Killeroo; the modes' frames are
    more than background."""
    te = trast.RasterizerExperiment(CPU)
    ts = te.init()
    for _ in range(mesh_idx):
        ts = te.handle_key(ts, "W")
    assert ts.mesh_idx == mesh_idx
    for per_pixel in ((False, True) if mesh_idx == 0 else (False,)):
        ts.per_pixel = per_pixel
        for _ in range(tsh.NUM_SHADERS):
            ts = te.handle_key(ts, "S")
            fb = te.render(ts, 64, 64, 0.1)
            assert fb.shape == (64, 64) and fb.dtype == torch.uint32
    assert ts.shader_idx == 5
    bg = tpp.overlay_cross(tpp.background(0, 64, 64, CPU),
                           ts._scene_cache[1].cross)
    for mode in (tpp.MODE_POINT, tpp.MODE_LINE):
        ts = te.handle_key(ts, "M")
        assert ts.mode == mode
        fb = te.render(ts, 64, 64, 0.1).view(torch.int32)
        assert int((fb != bg).sum()) > 0, tpp.MODE_NAMES[mode]
    assert te.handle_key(ts, "M").mode == tpp.MODE_FILL

"""PyTorch port vs the JAX package: the 16 shaders and fresnel_conductor
on seeded random fragments (bit for bit), every shader x mode
configuration as a whole frame, and the Plastic2xDirLight golden.

The port computes each shader op for op as the JAX source writes it, one
rounding per op, as the reference does. XLA:CPU does not, three ways
(ROADMAP C): its algebraic simplifier folds constant products ((a * 33)
* c becomes a * (33 * c)), moves a scalar product onto the smaller
operand of a broadcast, and turns 1.0 / sqrt(d) into its rsqrt, which
is not correctly rounded; and a seal whose zero comes from a
constant folds away, so Plastic2xDirLight's light dot products contract
into FMAs. So the functions are held bit for bit against JAX's compiled
in a subprocess without the simplifier (XLA_FLAGS
--xla_disable_hlo_passes=algsimp) and with the shaders' constant arrays
made run-time values (plus a zero argument). The frames compare with the
JAX package as it is; the differences stay below the 11-bit gamma pack.
They take the G-buffer oracle (JAX's backend "xla"), which runs no Pallas
kernel in either package, on a 1,024-triangle sphere at 128x128:
per-vertex (V) shades the vertices and interpolates, per-pixel (P)
shades every covered pixel. Aim and measure: 0 differing pixels.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.raster import shaders as jsh
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import structure as tstruct
from rustexp_tpu_torch.raster import shaders as tsh

W = H = 128
CPU = torch.device("cpu")
GOLDEN_FRAC = 0.003
N_FRAGMENTS = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fragments(seed: int, n: int = N_FRAGMENTS):
    """Seeded fragments: positions around the unit cube, unnormalized
    normals, baked colors in [0, 1], and an eye outside the mesh."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    eye = np.array([0.3, 0.25, 1.7], np.float32)
    return p, nrm, col, eye


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# Runs in a fresh interpreter: XLA_FLAGS must be set before jax starts.
_AS_WRITTEN = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from test_torch_shaders import _fragments
from rustexp_tpu.assets import cubemap
from rustexp_tpu.raster import shaders as jsh

zero = []


class RunTimeConstants:
    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def array(*a, **k):
        return jnp.array(*a, **k) + zero[-1]


def shade(idx, p, n, c, e, cm, z):
    zero.append(z)
    try:
        return jsh.shader_fn(idx)(p, n, c, e, 0.0, cm)
    finally:
        zero.pop()


jsh.jnp = RunTimeConstants()
cm = cubemap.make_procedural_set().data
f = jax.jit(shade, static_argnums=0)
out = {str(i): np.asarray(f(i, *_fragments(100 + i), cm, np.float32(0.0)))
       for i in range(jsh.NUM_SHADERS)}
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_as_written(tmp_path_factory):
    """JAX's 16 shaders on _fragments(100 + i), computed as written."""
    path = tmp_path_factory.mktemp("shaders") / "as_written.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=algsimp",
               PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", _AS_WRITTEN, str(path)], cwd=ROOT,
                   env=env, check=True, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("idx", range(jsh.NUM_SHADERS))
def test_shader_matches_jax(jax_as_written, idx):
    """Shader `idx` on 4,096 seeded fragments, bit for bit."""
    p, nrm, col, eye = _fragments(100 + idx)
    cm = jcubemap.make_procedural_set().data
    got = tsh.shader_fn(idx)(*map(torch.from_numpy, (p, nrm, col, eye)),
                             0.0, torch.from_numpy(cm))
    assert got.shape == (N_FRAGMENTS, 3) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    assert np.array_equal(_bits(got.numpy()),
                          _bits(jax_as_written[str(idx)]))
    assert tsh.shader_name(idx) == jsh.shader_name(idx)


def test_fresnel_conductor_matches_jax():
    rng = np.random.default_rng(3)
    cosi = rng.uniform(-1.5, 1.5, size=(4096, 1)).astype(np.float32)
    for eta, k in ((1.0, 1.1), (0.2, 3.0), (1.5, 0.0)):
        want = jax.jit(jsh.fresnel_conductor, static_argnums=(1, 2))(
            cosi, eta, k)
        got = tsh.fresnel_conductor(torch.from_numpy(cosi), eta, k)
        assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.fixture(scope="module")
def sphere():
    m = jmesh.make_sphere(16, 32)
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))


def _diff(a, b) -> int:
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint32
    return int((a != b).sum())


@pytest.mark.parametrize("per_pixel", [False, True], ids=["V", "P"])
def test_shader_configs_render_as_jax(sphere, per_pixel):
    """All 16 shaders in one mode, as whole frames: 0 differing pixels."""
    sj, st = sphere
    eye = camera.cam_orbit_front(1.1)
    kw = dict(w=W, h=H, per_pixel=per_pixel, show_cm=False)
    bg = tpp.background(0, W, H, CPU)
    for idx in range(tsh.NUM_SHADERS):
        want = jpp.render_frame(sj, jnp.asarray(eye), 1.1, shader_idx=idx,
                                backend="xla", **kw)
        got = tpp.render_frame(st, eye, 1.1, shader_idx=idx,
                               structure=tstruct.Structure(tstruct.ORACLE),
                               **kw)
        assert _diff(want, got) == 0, tsh.shader_name(idx)
        assert int((got.view(torch.int32) != bg).sum()) > W * H // 10


def test_golden_raster_sphere_plastic_v():
    """The port's frame against the JAX package's stored golden
    (tests/test_golden.py::test_golden_raster_plastic_vertex): shader 3
    per vertex through the bins."""
    st = tpp.make_scene(jmesh.make_sphere(12, 24),
                        tcubemap.make_procedural_set(), CPU)
    fb = tpp.render_frame(st, camera.cam_orbit_front(1.3), 1.3, w=W, h=H,
                          per_pixel=False, shader_idx=3, bg_idx=0,
                          show_cm=False,
                          structure=tstruct.Structure(tstruct.BINS))
    want = np.load("tests/goldens/raster_sphere_plastic_v.npz")["fb"]
    assert _diff(want, fb) <= GOLDEN_FRAC * W * H

"""PyTorch port (rustexp_tpu_torch) vs the JAX package: packing, LUTs,
cubemaps, backgrounds and shader 5, plus the port's import hygiene and the
paths it does not port yet.

Inputs are made with numpy from a seed and fed to both packages; every
comparison here is exact (the port rounds each op once, as the JAX
package's sealed CPU chains do — ops/ieee.py in both packages).
"""

import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.core import colors as jcolors
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.raster import shaders as jsh
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.assets import mesh as tmesh
from rustexp_tpu_torch.core import colors as tcolors
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import shaders as tsh

CPU = torch.device("cpu")


def _rgb(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.2, 1.2, size=(3, n)).astype(np.float32)
    # every 11-bit gamma index, the clamp edges and a NaN
    v[:, :2048] = (np.arange(2048, dtype=np.float32) + 0.5) / 2047.0
    v[:, 2048:2052] = np.array([0.0, 1.0, -0.0, np.nan], np.float32)
    return v


def test_lut_builders_match_jax():
    assert np.array_equal(tcolors.GAMMA_11BIT_LUT, jcolors.GAMMA_11BIT_LUT)
    assert np.array_equal(tcolors.POW16_TABLE, jcolors.POW16_TABLE)
    rgb = _rgb(1).T[:2048]
    assert np.array_equal(tcolors.pack_abgr32_gamma_np(rgb),
                          jcolors.pack_abgr32_gamma_np(rgb))


@pytest.mark.parametrize("name", ["pack_abgr32", "pack_abgr32_gamma_arith"])
def test_packers_match_jax(name):
    r, g, b = _rgb(2)
    want = np.asarray(jax.jit(getattr(jcolors, name))(r, g, b))
    got = getattr(tcolors, name)(*map(torch.from_numpy, (r, g, b)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_pow16_arith_matches_jax():
    v = np.concatenate([_rgb(3)[0], (np.arange(256, dtype=np.float32)
                                     + 600.5) / 855.0])
    want = np.asarray(jax.jit(jcolors.fast_unit_pow16_arith)(v))
    got = tcolors.fast_unit_pow16_arith(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_trunc_i32_saturates_like_xla():
    x = np.array([1e10, -1e10, np.nan, 2.9e9, -2.9e9, 2147483520.0,
                  -2147483648.0, 3.7, -3.7], np.float32)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.int32))(x))
    assert np.array_equal(tcolors.trunc_i32(torch.from_numpy(x)).numpy(), want)


def test_procedural_cubemap_matches_jax():
    a, b = jcubemap.make_procedural_set(), tcubemap.make_procedural_set()
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(a.cross, b.cross)
    assert b.cross.dtype == np.uint32


@pytest.mark.parametrize("bg_idx", range(jpp.NUM_BACKGROUNDS))
def test_background_matches_jax(bg_idx):
    want = np.asarray(jax.jit(jpp.background, static_argnums=(0, 1, 2))(
        bg_idx, 128, 96))
    got = tpp.background(bg_idx, 128, 96, CPU)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _shader_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    eye = np.array([0.3, 0.25, 1.7], np.float32)
    return p, nrm, col, eye


def test_cm_texel_from_dir_matches_jax():
    _, d, _, _ = _shader_inputs(4)
    d[:8] = [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, 0],
             [-1, 0, 0], [0, -2, 0], [0, 0, -3]]  # ties and the zero vector
    want = jax.jit(jsh.cm_texel_from_dir)(d)
    got = tsh.cm_texel_from_dir(torch.from_numpy(d))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_shader_cm_refl_matches_jax():
    p, nrm, col, eye = _shader_inputs(5)
    cm = jcubemap.make_procedural_set().data
    want = np.asarray(jax.jit(jsh.shader_cm_refl)(p, nrm, col, eye, 0.0, cm))
    got = tsh.shader_cm_refl(*map(torch.from_numpy, (p, nrm, col, eye)), 0.0,
                             torch.from_numpy(cm)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_shader_table_names_match_jax():
    assert tsh.NUM_SHADERS == jsh.NUM_SHADERS
    for i in range(jsh.NUM_SHADERS):
        assert tsh.shader_name(i) == jsh.shader_name(i)
        assert tsh.shader_uses_cm(i) == jsh.shader_uses_cm(i)
    assert tsh.shader_fn(5) is tsh.shader_cm_refl


def test_port_imports_no_jax():
    """The port runs where jax is not installed: importing every module of
    it must leave jax out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, rustexp_tpu_torch\n"
        "for m in pkgutil.walk_packages(rustexp_tpu_torch.__path__,\n"
        "                               'rustexp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import rustexp_tpu_torch.sims.rasterizer\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_unported_shaders_and_modes_raise():
    with pytest.raises(NotImplementedError, match="A5"):
        tsh.shader_fn(0)
    scene = tpp.make_scene(tmesh.make_sphere(4, 8),
                           tcubemap.make_procedural_set(), CPU)
    for kw, item in ((dict(backend="pallas"), "A9/B2"),
                     (dict(backend="queue"), "A9/B2"),
                     (dict(backend="queue", mode=tpp.MODE_LINE), "A10")):
        with pytest.raises(NotImplementedError, match=item):
            tpp.render_frame(scene, np.array([0, 0, 2], np.float32), 0.0,
                             w=128, h=128, **kw)

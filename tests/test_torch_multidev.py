"""PyTorch port: the CLI's --devices N and the multi-rank dry run
(ROADMAP A16), on gloo CPU ranks.

``--devices 2`` and ``--devices 4`` with ``--device cpu`` run every
experiment on spawned ranks (app/multidev.py), rank 0 writing the PNGs;
each PNG must equal the frame the one-rank port computes for the same
configuration (GoL steps of step_roll, block BH steps of step_bh, the
queue frame of render_frame, sine_frame), and GoL's also the JAX
package's run_multidevice on a 2-device mesh: 0 px everywhere. Then the
refusals (--animate with --devices, a configuration a rank refuses, no
card without --device cpu) and dryrun_multichip(4, "cpu").
Wall time on the test machine: about 90 s alone.
"""

import os

import numpy as np
import jax
import pytest
import torch

from rustexp_tpu.app import multidev as jmultidev
from rustexp_tpu.core import framebuffer as jfb
from rustexp_tpu_torch.app import cli, multidev
from rustexp_tpu_torch.assets import cubemap, mesh as meshes
from rustexp_tpu_torch.core import framebuffer as fbm, prng
from rustexp_tpu_torch.ops import gol_stencil, nbody_bh
from rustexp_tpu_torch.raster import camera, pipeline as pp
from rustexp_tpu_torch.raster import structure as rs
from rustexp_tpu_torch.sims.gol import GoLExperiment, gol_render
from rustexp_tpu_torch.sims.nbody import nbody_render, stable_orbits
from rustexp_tpu_torch.sims.sine import sine_frame

CPU = torch.device("cpu")
SIZE = 128
FRAMES = 2


def _gol_frames(n_dev):
    g = GoLExperiment(CPU).init(n=256).grid.to(torch.int32)
    out = []
    for _ in range(FRAMES):
        for _ in range(8):
            g = gol_stencil.step_roll(g)
        out.append(gol_render(g, SIZE, SIZE))
    return out


def _nbody_frames(n_dev):
    n = 256 * 8 * n_dev
    st = stable_orbits(prng.key(0), n, device=CPU)
    k = nbody_bh.theta_to_k(0.85, n // 256)
    out = []
    for _ in range(FRAMES):
        st = nbody_bh.step_bh(*st, 256, k, 0.01)
        out.append(nbody_render(*st[:4], SIZE, SIZE))
    return out


def _raster_frames(n_dev):
    scene = pp.make_scene(meshes.get_mesh(0), cubemap.get_cm_set(0), CPU)
    out = []
    for i in range(FRAMES):
        tick = i / 60.0
        eye = camera.camera_eye(meshes.mesh_camera(0), tick)
        q = rs.build(scene, rs.QUEUE, eye, SIZE, SIZE)
        out.append(pp.render_frame(scene, eye, tick, w=SIZE, h=SIZE,
                                   structure=q, show_cm=False))
    return out


def _sine_frames(n_dev):
    return [sine_frame(SIZE, SIZE, i / 60.0, CPU) for i in range(FRAMES)]


FRAMES_OF = {"gol": _gol_frames, "nbody": _nbody_frames,
             "rasterizer": _raster_frames, "sine": _sine_frames}
LABEL = {"gol": "[pallas]", "nbody": "bh(th=0.85)", "rasterizer": "Killeroo",
         "sine": "sine"}


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("experiment", sorted(FRAMES_OF))
def test_cli_devices_on_cpu_ranks(experiment, n_dev, tmp_path, capsys):
    """The experiment over n_dev gloo CPU ranks: rank 0's PNGs equal the
    one-rank frames, its status lines name the path, every rank reports
    its launches (none on the CPU)."""
    out = str(tmp_path / "f")
    rc = cli.main([experiment, "--devices", str(n_dev), "--device", "cpu",
                   "--frames", str(FRAMES), "--size", str(SIZE),
                   "--no-overlay", "--out", out])
    text = capsys.readouterr().out
    assert rc == 0
    assert f"{FRAMES} frames, median" in text and f"{n_dev} ranks" in text
    assert f"[{FRAMES - 1}]" in text and LABEL[experiment] in text
    for r in range(n_dev):
        assert f"rank {r} kernel launches: {{}}" in text
    for i, fb in enumerate(FRAMES_OF[experiment](n_dev)):
        png = fbm.read_png(f"{out}_{i:03d}.png")
        assert np.array_equal(png, fbm.to_rgb8_topleft(fb)), (experiment, i)


def test_cli_devices_gol_matches_jax(tmp_path, capsys):
    """GoL over 2 ranks against the JAX package's run_multidevice on a
    2-device mesh: the same PNG bytes' pixels, frame for frame."""
    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    assert cli.main(["gol", "--devices", "2", "--device", "cpu", "--frames",
                     str(FRAMES), "--size", str(SIZE), "--no-overlay",
                     "--out", out]) == 0
    jmultidev.run_multidevice("gol", 2, FRAMES, SIZE, jout, overlay=False)
    capsys.readouterr()
    for i in range(FRAMES):
        assert np.array_equal(fbm.read_png(f"{out}_{i:03d}.png"),
                              jfb.read_png(f"{jout}_{i:03d}.png")), i
    jax.config.update("jax_default_device", None)


def test_cli_devices_refusals(monkeypatch, tmp_path):
    """--animate with --devices is refused, as JAX refuses it; a
    configuration a rank refuses ends the run with its message and no
    PNG; without --device cpu and without a card the CLI exits non-zero
    before any rank starts."""
    with pytest.raises(SystemExit, match="drop --devices"):
        cli.main(["rasterizer", "--device", "cpu", "--devices", "2",
                  "--animate", "2"])
    out = str(tmp_path / "g")
    with pytest.raises(SystemExit, match="doesn't divide over 4 devices"):
        cli.main(["gol", "--device", "cpu", "--devices", "4", "--grid",
                  "250", "--frames", "1", "--out", out])
    with pytest.raises(SystemExit, match="not divisible into 4"):
        cli.main(["rasterizer", "--device", "cpu", "--devices", "4",
                  "--size", "96", "--frames", "1"])
    assert not os.path.exists(f"{out}_000.png")
    with pytest.raises(SystemExit, match="does not support"):
        multidev.run_multidevice("bench", 2, 1, 64, "", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["gol", "--devices", "2", "--frames", "1"])
    assert e.value.code not in (None, 0) and "--device cpu" in str(
        e.value.code)


def test_dryrun_multichip_on_cpu_ranks():
    """dryrun_multichip(4, "cpu"): the ten steps of the JAX package's
    dry run on 4 gloo ranks, the two-axis mesh as the group of all
    ranks; no kernel launches on the CPU."""
    res = multidev.dryrun_multichip(4, "cpu")
    assert len(res) == 4
    for r in res:
        assert r["steps"] == ["sine", "gol roll", "nbody brute",
                              "gbuffer xla", "gbuffer pallas", "queue bands",
                              "nbody bh", "gol pallas", "gol bits",
                              "combined axis"]
        assert not any(r["launches"].values())

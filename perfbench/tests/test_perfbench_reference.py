"""The plain reference against the measured program's CPU frames at 512².

Both configurations, at the reference benchmark's fixed eye (the bench
entry) and at orbit ticks (the Experiment's render, with the cube-map
cross), held to the configurations' own `px_off` limits. The tests may
import the program; the reference never does.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import assets, raster

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def px_off(fb, ref):
    got = fb.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return int((got != ref).sum())


def ref_frame(c, tick, show_cm):
    cm, cross = assets.ENVMAPS[c["envmap"]]()
    return raster.render(assets.MESHES[c["mesh"]](), cm, cross,
                         assets.eye(c["camera"], tick), w=c["width"],
                         h=c["height"], per_pixel=c["per_pixel"],
                         shader=c["shader"], bg=c["background"],
                         show_cm=show_cm, device="cpu")


@pytest.mark.parametrize("name", ["rast512_sphere_p", "rast512_cube_p"])
def test_fixed_eye_frame(name):
    from rustexp_tpu_torch.app import benchmark as bm

    c = cfg(name)
    frame, _, _, _ = bm.scene_frame(c["mesh_idx"], c["per_pixel"],
                                    torch.device("cpu"))
    fb, stale = frame()
    assert not bool(stale)
    assert px_off(fb, ref_frame(c, 0.0, False)) <= \
        c["correct_limits"]["px_off"]


@pytest.mark.parametrize("name", ["rast512_sphere_p", "rast512_cube_p"])
def test_orbit_frames(name):
    from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

    c = cfg(name)
    exp = RasterizerExperiment("cpu")
    st = exp.init(per_pixel=True, mesh_idx=c["mesh_idx"],
                  shader_idx=c["shader"], env_idx=c["env_idx"],
                  bg_idx=c["background"])
    for tick in (0.0, 1 / 60, 7.3, 40.0):
        fb = exp.render(st, c["width"], c["height"], tick)
        assert px_off(fb, ref_frame(c, tick, True)) <= \
            c["correct_limits"]["px_off"], tick


@pytest.mark.parametrize("name", ["rast512_sphere_p", "rast512_cube_p"])
def test_inputs_equal_the_programs(name):
    from rustexp_tpu_torch.assets import cubemap, mesh

    from perfbench.entries.common import check_inputs

    c = cfg(name)
    check_inputs(c, mesh.get_mesh(c["mesh_idx"]),
                 cubemap.get_cm_set(c["env_idx"]))
    other = mesh.get_mesh(6)  # the torus knot: not this configuration's
    with pytest.raises(RuntimeError, match="other inputs"):
        check_inputs(c, other, cubemap.get_cm_set(c["env_idx"]))


def test_lower_precision_is_refused():
    """The control (bfloat16) must fail the limit at the fixed eye."""
    for name in ("rast512_sphere_p", "rast512_cube_p"):
        c = cfg(name)
        cm, cross = assets.ENVMAPS[c["envmap"]]()
        low = raster.render(assets.MESHES[c["mesh"]](), cm, cross,
                            assets.eye(c["camera"], 0.0), w=512, h=512,
                            per_pixel=True, shader=5, bg=0, show_cm=False,
                            device="cpu", dtype=torch.bfloat16)
        off = int((low != ref_frame(c, 0.0, False)).sum())
        assert off > c["correct_limits"]["px_off"], (name, off)


def test_camera_paths_match_the_programs():
    from rustexp_tpu_torch.raster import camera

    for name in ("orbit", "orbit_front"):
        for tick in np.linspace(0.0, 60.0, 97):
            assert np.array_equal(assets.eye(name, tick),
                                  camera.camera_eye(name, tick))

"""The shading and pack layer (raster/shade.py) on the CPU.

CPU tensors take the plain chain and never load the shade kernel's
library: the benchmark's two bench scenes render the frames they rendered
before the kernel existed, bit for bit. The plain chain's forms agree
with one another (a rows list, compacted or not, is the whole-frame shade
on its blocks; a band's y0 is its y_rows), and the kernel's wrapper
refuses what it cannot launch before it loads anything.
"""

import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import shade_inputs
from rustexp_tpu_torch.app import benchmark as bench
from rustexp_tpu_torch.raster import camera
from rustexp_tpu_torch.raster import shade as sd

CPU = torch.device("cpu")
H, W, BW = 32, 256, 64
EYE = camera.camera_eye("orbit", 0.7)

# sha256 of scene_frame(mesh_idx, per_pixel=True)'s CPU frame (uint32,
# little-endian), as the frame path rendered it before the shade kernel:
# KillerooP takes the queue and the compacted ray-world shade, CubeP the
# bins and the whole-frame shade.
BENCH_FRAMES = {
    0: "4a47276954b90a348a4032584d566efd3507b9de8b29ef66dde1105de2115e8a",
    9: "f8d57e39676e58014c963ccf3f1f36dd4bb66a12734cfb639b00b67e1917b7b8",
}


def _no_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path loaded the shade kernel")

    monkeypatch.setattr(sd, "load_kernel_lib", refuse)
    monkeypatch.setattr(sd, "shade_pack_cuda", refuse)


@pytest.mark.parametrize("mesh_idx", sorted(BENCH_FRAMES))
def test_bench_frames_on_cpu_take_the_plain_chain(mesh_idx, monkeypatch):
    """scene_frame's frame on the CPU never reaches the kernel's library
    and equals the frame of the plain chain before the kernel, bit for
    bit."""
    _no_library(monkeypatch)
    frame = bench.scene_frame(mesh_idx, True, CPU)[0]
    fb, stale = frame()
    assert fb.dtype == torch.uint32 and not bool(stale)
    got = hashlib.sha256(
        fb.view(torch.int32).numpy().astype("<i4").tobytes()).hexdigest()
    assert got == BENCH_FRAMES[mesh_idx]


def _plain(planes, inputs, shader_idx, per_pixel, ray_world, **kw):
    return sd.shade_pack(*planes, inputs[3], inputs[4], EYE, 0.0,
                         shader_idx=shader_idx, per_pixel=per_pixel,
                         ray_world=ray_world, **kw)


@pytest.mark.parametrize("per_pixel,ray_world", [(True, True), (True, False),
                                                 (False, False)])
def test_plain_rows_forms_are_the_dense_shade_on_their_blocks(
        per_pixel, ray_world, monkeypatch):
    """A rows list shades its blocks as the whole-frame shade does and
    leaves the rest (and the pads) background; the compacted list gives
    the same frame."""
    _no_library(monkeypatch)
    inputs = shade_inputs(H, W, per_pixel, ray_world, CPU, seed=3,
                          block_w=BW)
    mask, z, lin, bg, _, rows = inputs
    dense = _plain((mask, z, lin), inputs, 5, per_pixel, ray_world)
    got = _plain((mask, z, lin), inputs, 5, per_pixel, ray_world, rows=rows,
                 block_w=BW)
    n_blk = H * (W // BW)
    listed = torch.zeros(n_blk, dtype=torch.bool)
    listed[rows[rows < n_blk].long()] = True
    listed = listed.repeat_interleave(BW).reshape(H, W)
    assert torch.equal(got, torch.where(listed, dense, bg))
    assert bool((dense != bg).any()) and bool((~listed).any())
    rows_g = torch.where(rows >= n_blk, 0, rows).long()

    def take(p_):
        return p_.reshape(n_blk, BW)[rows_g]

    compact = _plain((take(mask), take(z), [take(p_) for p_ in lin]), inputs,
                     5, per_pixel, ray_world, rows=rows, block_w=BW,
                     compact=True)
    assert torch.equal(compact, got)


def test_plain_band_rows_agree(monkeypatch):
    """A band's rays at global rows: y0 and full_h give the frame that the
    same rows as a y_rows list give, and differ from the band at row 0."""
    _no_library(monkeypatch)
    inputs = shade_inputs(H, W, True, True, CPU, seed=4, block_w=BW)
    planes = inputs[:3]
    y0 = _plain(planes, inputs, 5, True, True, y0=96, full_h=256)
    y_rows = _plain(planes, inputs, 5, True, True, full_h=256,
                    y_rows=list(range(96, 96 + H)))
    top = _plain(planes, inputs, 5, True, True, full_h=256)
    assert torch.equal(y0, y_rows) and not torch.equal(y0, top)


def test_inv_world_to_vp_inverts_the_world_to_viewport_chain():
    """The ray matrix the shade unprojects with (and the kernel forms from
    the eye) takes a world point's viewport coordinates back to it."""
    from rustexp_tpu_torch.raster import pipeline as pp

    m = pp._world_to_vp_exact(sd._host_eye(EYE), W, H).double()
    inv = sd.inv_world_to_vp(EYE, W, H).double()
    pts = torch.tensor([[0.1, -0.2, 0.3, 1.0], [-0.4, 0.25, 0.0, 1.0]],
                       dtype=torch.float64)
    for p_ in pts:
        clip = m @ p_
        vp = torch.cat([clip[:3] / clip[3], clip.new_ones(1)])
        back = inv @ vp
        np.testing.assert_allclose((back[:3] / back[3]).numpy(),
                                   p_[:3].numpy(), atol=1e-4)


@pytest.mark.parametrize("case", ["cpu", "planes", "shader", "block_w"])
def test_shade_pack_cuda_refuses_before_loading(case, monkeypatch):
    """The kernel's wrapper raises on CPU tensors, a wrong plane count, a
    shader index out of range and a block width that does not divide the
    frame, all before it loads the library."""
    monkeypatch.setattr(sd, "load_kernel_lib", lambda name: pytest.fail(
        f"loaded {name}"))
    mask, z, lin, bg, cm, rows = shade_inputs(H, W, True, True, CPU)
    kw = dict(shader_idx=5, per_pixel=True, ray_world=True)
    why = "CUDA tensors"
    if case == "planes":
        lin, why = lin[:4], "planes"
    elif case == "shader":
        kw["shader_idx"], why = 16, "shader index"
    elif case == "block_w":
        kw.update(rows=rows, block_w=100)
        why = "does not divide"
    with pytest.raises(ValueError, match=why):
        sd.shade_pack_cuda(mask, z, lin, bg, cm, EYE, **kw)

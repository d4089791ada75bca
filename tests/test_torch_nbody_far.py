"""The Barnes-Hut far field's kernel F (csrc/nbody_forces.cu,
ops/nbody_bh.py far_field_cuda) and its dispatch.

The CPU tests hold the wrapper's refusals, each made before any library
is loaded, far_field's CPU route, which never loads one, the Barnes-Hut
forces on the CPU, and the plain chain's sum against an independent one.
The ``cuda`` tests hold the kernel against its plain version on the card
at the main paths' shapes, its bits from call to call, over a slice of
the target blocks and over strided monopoles, NaN for a row out of
range, one launch a Barnes-Hut step inside the span nbody.far and no
synchronizing call. This file imports no jax, so on the card's machine
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nbody_far.py
"""

import pytest
import torch

from rustexp_tpu_torch.core import prng
from rustexp_tpu_torch.ops import nbody_bh as bh
from rustexp_tpu_torch.ops.nbody_forces import EPS
from rustexp_tpu_torch.sims.nbody import NBodyExperiment, stable_orbits

# the largest |dF| over the largest |F|: float32 sums in another order
# (per tile and per group of monopoles, against torch's reduction over
# all of them) and the pair fused (B5's pair: one reciprocal rounded,
# then the product with the mass, where the plain chain divides once)
FAR_RTOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py on the card)")
    return torch.device("cuda")


def _blocks(n: int, block: int, k: int, dev):
    """The Morton-sorted stable-orbit disk of n bodies cut into blocks ->
    (xb, yb, mb, msum, cx, cy, idx), as forces_bh_sorted makes them."""
    px, py, _, _, m = stable_orbits(prng.key(n), n, device=dev)
    px, py, m = bh.morton_sort(px, py, m)
    xb, yb, mb = (a.reshape(n // block, block) for a in (px, py, m))
    msum, cx, cy = bh.block_aggregates(xb, yb, mb)
    idx = bh.near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                yb.amax(1), k)
    return xb, yb, mb, msum, cx, cy, idx


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to load a kernel library fails the test."""
    def refuse(*_):
        pytest.fail("a kernel library was loaded")

    monkeypatch.setattr(bh, "load_kernel_lib", refuse)
    monkeypatch.setattr(bh, "_far_kernel", refuse)
    monkeypatch.setattr(bh, "_near_kernel", refuse)


def _args(nt=4, nb=8, block=16, k=3):
    xt = torch.rand(nt, block)
    yt = torch.rand(nt, block)
    mono = [torch.rand(nb) for _ in range(3)]
    idx = torch.zeros(nt, k, dtype=torch.int64)
    return [xt, yt, *mono, idx]


def _with(i, value):
    args = _args()
    args[i] = value(args[i]) if callable(value) else value
    return args


REFUSED = {
    "cpu tensors": (_args(), "runs on CUDA tensors"),
    "meta tensors": ([t.to("meta") for t in _args()], "runs on CUDA"),
    "f64 targets": (_with(0, lambda t: t.double()), "xt: need a 2-D"),
    "f16 monopoles": (_with(3, lambda t: t.half()), "cx: need a 1-D"),
    "int32 idx": (_with(5, lambda t: t.int()), "idx: need a 2-D"),
    "ragged N, flat": (_with(0, torch.rand(1000)), "xt: need a 2-D"),
    "monopoles as a column": (_with(2, lambda t: t[:, None]),
                              "msum: need a 1-D"),
    "ragged blocks": (_with(1, torch.rand(4, 15)), "yt: need shape"),
    "fewer centres than masses": (_with(4, torch.rand(7)),
                                  r"cy: need shape \(8,\)"),
    "idx rows unlike the targets'": (_with(5, torch.zeros(
        3, 3, dtype=torch.int64)), "idx: need shape"),
    "K over the block count": (_with(5, torch.zeros(4, 9,
                                                    dtype=torch.int64)),
                               "1 <= K <= 8"),
    "block over 256": (_args(block=300), "1 <= block <= 256"),
    "strided targets": (_with(0, lambda t: t.t().contiguous().t()),
                        "xt: need a contiguous"),
    "strided idx columns": (_with(5, lambda t: torch.zeros(
        4, 6, dtype=torch.int64)[:, ::2]), "idx: need unit-stride rows"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_far_field_cuda_refuses_before_loading(case, no_library):
    args, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        bh.far_field_cuda(*args)


def test_far_field_on_cpu_takes_the_plain_chain(no_library):
    """far_field on CPU tensors equals far_field_plain bit for bit and
    never loads the library."""
    xb, yb, _, msum, cx, cy, idx = _blocks(1024, 128, 6, "cpu")
    got = bh.far_field(xb, yb, msum, cx, cy, idx)
    want = bh.far_field_plain(xb, yb, msum, cx, cy, idx)
    assert _same_bits(got, want)


def test_forces_bh_sorted_on_cpu_is_the_plain_halves(no_library):
    """forces_bh_sorted on the CPU is the plain near field plus the plain
    far field times the target mass, bit for bit, with no library."""
    n, block, k = 2048, 128, 6
    xb, yb, mb, msum, cx, cy, idx = _blocks(n, block, k, "cpu")
    fx, fy = bh.near_field_plain(xb, yb, xb, yb, mb, idx)
    gx, gy = bh.far_field_plain(xb, yb, msum, cx, cy, idx)
    m = mb.reshape(-1)
    want = ((fx.reshape(-1) + gx) * m, (fy.reshape(-1) + gy) * m)
    got = bh.forces_bh_sorted(xb.reshape(-1), yb.reshape(-1), m, block, k)
    assert _same_bits(got, want)


@pytest.mark.parametrize("n,block,k", [(1024, 128, 6), (1000, 40, 3)])
def test_far_field_plain_is_the_monopoles_outside_the_near_set(n, block, k):
    """The plain chain's sum is each block's monopole outside the target
    block's near set, added one block at a time in float64: the terms
    kernel F adds, in another order."""
    xb, yb, _, msum, cx, cy, idx = _blocks(n, block, k, "cpu")
    gx, gy = bh.far_field_plain(xb, yb, msum, cx, cy, idx)
    nt, nb = xb.shape[0], msum.shape[0]
    wx = torch.zeros(nt, block, dtype=torch.float64)
    wy = torch.zeros_like(wx)
    x, y = xb.double(), yb.double()
    for j in range(nb):
        dx, dy = float(cx[j]) - x, float(cy[j]) - y
        r = float(msum[j]) / (dx * dx + dy * dy + EPS)
        far = (idx != j).all(dim=1)[:, None]
        wx += torch.where(far, r * dx, 0.0)
        wy += torch.where(far, r * dy, 0.0)
    assert _rel((gx, gy), (wx.reshape(-1), wy.reshape(-1))) <= FAR_RTOL


def test_far_field_plain_of_an_all_near_set_is_zero():
    """With every block in each near set, no monopole is left: zero."""
    xb, yb, _, msum, cx, cy, _ = _blocks(1024, 128, 2, "cpu")
    nb = msum.shape[0]
    idx = torch.arange(nb).repeat(nb, 1)
    gx, gy = bh.far_field_plain(xb, yb, msum, cx, cy, idx)
    assert not gx.any() and not gy.any()


def _rel(got, want) -> float:
    (kx, ky), (px, py) = got, want
    return float(torch.hypot(kx - px, ky - py).max()
                 / torch.hypot(px, py).max())


def _same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,k", [(131_072, 256, 27), (10_000, 200, 27),
                                       (4096, 128, 6)])
def test_far_kernel_matches_plain_on_card(n, block, k):
    """Within FAR_RTOL of the plain chain on the Morton-sorted disk, one
    launch a call."""
    dev = _card()
    xb, yb, _, msum, cx, cy, idx = _blocks(n, block, k, dev)
    launches = bh.far_field_cuda.launches
    got = bh.far_field_cuda(xb, yb, msum, cx, cy, idx)
    assert bh.far_field_cuda.launches == launches + 1
    assert _rel(got, bh.far_field_plain(xb, yb, msum, cx, cy, idx)) \
        <= FAR_RTOL


@pytest.mark.cuda
def test_far_kernel_gives_the_same_bits_twice():
    dev = _card()
    xb, yb, _, msum, cx, cy, idx = _blocks(131_072, 256, 27, dev)
    first = bh.far_field_cuda(xb, yb, msum, cx, cy, idx)
    assert _same_bits(first, bh.far_field_cuda(xb, yb, msum, cx, cy, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [4, 3])
def test_far_kernel_target_slice_on_card(ranks):
    """A slice of the target blocks, with its rows of idx ranked as the
    sharded step ranks them, gets those rows of the whole call bit for
    bit."""
    dev = _card()
    n, block, k = 98_304, 256, 27
    xb, yb, _, msum, cx, cy, idx = _blocks(n, block, k, dev)
    whole = bh.far_field_cuda(xb, yb, msum, cx, cy, idx)
    rows = n // block // ranks
    for r in range(ranks):
        r0 = r * rows
        idx_r = bh.near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                      yb.amax(1), k, row0=r0, rows=rows)
        got = bh.far_field_cuda(xb[r0:r0 + rows], yb[r0:r0 + rows], msum,
                                cx, cy, idx_r)
        lo, hi = r0 * block, (r0 + rows) * block
        assert _same_bits(got, (f[lo:hi] for f in whole))


@pytest.mark.cuda
def test_far_kernel_takes_strided_monopoles():
    """The monopoles as columns of one table, as the sharded step's
    distributed sort unbinds them, give the contiguous call's bits."""
    dev = _card()
    xb, yb, _, msum, cx, cy, idx = _blocks(4096, 128, 6, dev)
    whole = bh.far_field_cuda(xb, yb, msum, cx, cy, idx)
    table = torch.stack([msum, cx, cy, msum], dim=1)
    got = bh.far_field_cuda(xb, yb, *table.unbind(1)[:3], idx)
    assert _same_bits(got, whole)


@pytest.mark.cuda
def test_far_kernel_gives_nan_for_a_row_out_of_range():
    """A row naming a block past the last, or a negative one, gives its
    target block NaN and leaves the others' bits alone."""
    dev = _card()
    xb, yb, _, msum, cx, cy, idx = _blocks(4096, 128, 6, dev)
    block = xb.shape[1]
    whole = bh.far_field_cuda(xb, yb, msum, cx, cy, idx)
    bad = idx.clone()
    bad[5, 3] = msum.shape[0]
    bad[9, 0] = -1
    got = bh.far_field_cuda(xb, yb, msum, cx, cy, bad)
    torch.cuda.synchronize()
    rows = torch.arange(xb.shape[0], device=dev).repeat_interleave(block)
    hit = (rows == 5) | (rows == 9)
    for f in got:
        assert torch.isnan(f[hit]).all()
    assert _same_bits((f[~hit] for f in got), (f[~hit] for f in whole))


@pytest.mark.cuda
def test_bh_step_launches_far_once_inside_its_span():
    """A step of the nbody.bh131k cell's Experiment launches kernel F
    once, and the profiler puts that launch inside nbody.far."""
    from perfbench import profiling

    from test_torch_trace import _launch_chain

    dev = _card()
    exp = NBodyExperiment(dev)
    st = exp.init("orbits", 131_072)
    exp.step(st)
    launches = bh.far_field_cuda.launches
    exp.step(st)
    assert bh.far_field_cuda.launches == launches + 1
    session = profiling.profile_frames(lambda: exp.step(st), 2)
    far = [a for a in session.device if "::far_kernel(" in a.name]
    assert len(far) == session.frames == 2
    for act in far:
        assert "nbody.far" in _launch_chain(session, act)


@pytest.mark.cuda
def test_far_field_cuda_makes_no_synchronizing_call():
    """Under the sync debug mode's "error", a call raises on any host
    wait; far_field_cuda makes none."""
    dev = _card()
    xb, yb, _, msum, cx, cy, idx = _blocks(131_072, 256, 27, dev)
    bh.far_field_cuda(xb, yb, msum, cx, cy, idx)  # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bh.far_field_cuda(xb, yb, msum, cx, cy, idx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()

"""The Barnes-Hut near field's kernel N (csrc/nbody_forces.cu,
ops/nbody_bh.py near_field_cuda) and its dispatch.

The CPU tests hold the wrapper's refusals, each made before any library
is loaded, and near_field's CPU route, which never loads one. The
``cuda`` tests hold the kernel against its plain version on the card at
the main paths' shapes, its bits from call to call and over a slice of
the target blocks, the sharded step's slices against the one-rank step,
and one launch a Barnes-Hut step inside the span nbody.near. This file
imports no jax, so on the card's machine it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nbody_near.py
"""

import pytest
import torch

from rustexp_tpu_torch.core import prng
from rustexp_tpu_torch.ops import nbody_bh as bh
from rustexp_tpu_torch.ops.nbody_forces import euler, kill_runaway
from rustexp_tpu_torch.sims.nbody import NBodyExperiment, stable_orbits

# the largest |dF| over the largest |F|: float32 sums in another order
# and the pair fused (B5's pair), as chip_smoke.B5_RTOL
NEAR_RTOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py on the card)")
    return torch.device("cuda")


def _blocks(n: int, block: int, k: int, dev):
    """The Morton-sorted stable-orbit disk of n bodies cut into blocks ->
    (xb, yb, mb, idx), as forces_bh_sorted makes them."""
    px, py, _, _, m = stable_orbits(prng.key(n), n, device=dev)
    px, py, m = bh.morton_sort(px, py, m)
    xb, yb, mb = (a.reshape(n // block, block) for a in (px, py, m))
    idx = bh.near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                yb.amax(1), k)
    return xb, yb, mb, idx


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to load a kernel library fails the test."""
    def refuse(*_):
        pytest.fail("a kernel library was loaded")

    monkeypatch.setattr(bh, "load_kernel_lib", refuse)
    monkeypatch.setattr(bh, "_near_kernel", refuse)


def _args(nt=4, nb=8, block=16, k=3):
    xb = torch.rand(nb, block)
    yb = torch.rand(nb, block)
    mb = torch.ones(nb, block)
    idx = torch.zeros(nt, k, dtype=torch.int64)
    return [xb[:nt].clone(), yb[:nt].clone(), xb, yb, mb, idx]


def _with(i, value):
    args = _args()
    args[i] = value(args[i]) if callable(value) else value
    return args


REFUSED = {
    "cpu tensors": (_args(), "runs on CUDA tensors"),
    "f64 targets": (_with(0, lambda t: t.double()), "xt: need a 2-D"),
    "int32 idx": (_with(5, lambda t: t.int()), "idx: need a 2-D"),
    "strided sources": (_with(2, lambda t: t.t().contiguous().t()),
                        "xb: need a contiguous"),
    "strided idx columns": (_with(5, lambda t: torch.zeros(
        4, 6, dtype=torch.int64)[:, ::2]), "idx: need unit-stride rows"),
    "K over the block count": (_with(5, torch.zeros(4, 9,
                                                    dtype=torch.int64)),
                               "1 <= K <= 8"),
    "idx rows unlike the targets'": (_with(5, torch.zeros(
        3, 3, dtype=torch.int64)), "idx: need shape"),
    "ragged N, flat": (_with(0, torch.rand(1000)), "xt: need a 2-D"),
    "ragged blocks": (_with(1, torch.rand(4, 15)), "yt: need shape"),
    "block over 256": (_args(block=300), "1 <= block <= 256"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_near_field_cuda_refuses_before_loading(case, no_library):
    args, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        bh.near_field_cuda(*args)


def test_near_field_on_cpu_takes_the_plain_chain(no_library):
    """near_field and forces_bh_sorted on CPU tensors never load the
    library; near_field equals near_field_plain bit for bit."""
    dev = torch.device("cpu")
    xb, yb, mb, idx = _blocks(1024, 128, 6, dev)
    got = bh.near_field(xb, yb, xb, yb, mb, idx)
    want = bh.near_field_plain(xb, yb, xb, yb, mb, idx)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    fx, fy = bh.forces_bh_sorted(xb.reshape(-1), yb.reshape(-1),
                                 mb.reshape(-1), 128, 6)
    assert torch.isfinite(fx).all() and torch.isfinite(fy).all()


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
def test_near_kernel_matches_plain_on_card(n, block, k):
    """Within NEAR_RTOL of the plain chain on the Morton-sorted disk, one
    launch a call, the same bits from two calls."""
    dev = _card()
    xb, yb, mb, idx = _blocks(n, block, k, dev)
    launches = bh.near_field_cuda.launches
    got = bh.near_field_cuda(xb, yb, xb, yb, mb, idx)
    assert bh.near_field_cuda.launches == launches + 1
    again = bh.near_field_cuda(xb, yb, xb, yb, mb, idx)
    assert _same_bits(got, again)
    assert _rel(got, bh.near_field_plain(xb, yb, xb, yb, mb, idx)) \
        <= NEAR_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,k,ranks", [(131_072, 256, 27, 4),
                                             (10_000, 200, 27, 5)])
def test_near_kernel_target_slice_on_card(n, block, k, ranks):
    """A slice of the target blocks, with its rows of idx ranked as the
    sharded step ranks them, gets those rows of the whole call bit for
    bit."""
    dev = _card()
    xb, yb, mb, idx = _blocks(n, block, k, dev)
    whole = bh.near_field_cuda(xb, yb, xb, yb, mb, idx)
    rows = n // block // ranks
    for r in range(ranks):
        r0 = r * rows
        idx_r = bh.near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                      yb.amax(1), k, row0=r0, rows=rows)
        got = bh.near_field_cuda(xb[r0:r0 + rows], yb[r0:r0 + rows], xb, yb,
                                 mb, idx_r)
        assert _same_bits(got, (f[r0:r0 + rows] for f in whole))


@pytest.mark.cuda
def test_near_kernel_gives_nan_for_a_row_out_of_range():
    """A row naming a block past the last gives its target block NaN and
    leaves the others' bits alone."""
    dev = _card()
    xb, yb, mb, idx = _blocks(4096, 128, 6, dev)
    whole = bh.near_field_cuda(xb, yb, xb, yb, mb, idx)
    bad = idx.clone()
    bad[5, 3] = xb.shape[0]
    got = bh.near_field_cuda(xb, yb, xb, yb, mb, bad)
    torch.cuda.synchronize()
    keep = torch.arange(xb.shape[0], device=dev) != 5
    assert torch.isnan(got[0][5]).all() and torch.isnan(got[1][5]).all()
    assert _same_bits((f[keep] for f in got), (f[keep] for f in whole))


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [4, 3])
def test_sharded_bh_step_equals_step_bh_on_card(ranks):
    """The body each rank of parallel/nbody_shard.make_step_bh runs with
    the replicated sort (its target blocks, their near sets ranked from
    row0, forces_on_blocks, the update), rank by rank in one process, is
    one-rank step_bh's particles bit for bit."""
    dev = _card()
    n, block, k = 98_304, 256, 27
    ics = stable_orbits(prng.key(3), n, device=dev)
    want = bh.step_bh(*ics, block, k, 0.01)
    px, py, vx, vy, m = ics
    px, py, m, vx, vy = bh.morton_sort(px, py, m, vx, vy)
    B = n // block
    xb, yb, mb = (a.reshape(B, block) for a in (px, py, m))
    msum, cx, cy = bh.block_aggregates(xb, yb, mb)
    nb_loc = B // ranks
    parts = []
    for r in range(ranks):
        b0, lo, hi = r * nb_loc, r * nb_loc * block, (r + 1) * nb_loc * block
        idx = bh.near_block_indices(xb.amin(1), xb.amax(1), yb.amin(1),
                                    yb.amax(1), k, row0=b0, rows=nb_loc)
        xt, yt = xb[b0:b0 + nb_loc], yb[b0:b0 + nb_loc]
        fx, fy = bh.forces_on_blocks(xt, yt, xb, yb, mb, msum, cx, cy, idx)
        sl = euler(xt.reshape(-1), yt.reshape(-1), vx[lo:hi], vy[lo:hi],
                   m[lo:hi], fx * m[lo:hi], fy * m[lo:hi], 0.01)
        parts.append((*sl[:2], *kill_runaway(*sl)))
    got = [torch.cat([p[i] for p in parts]) for i in (0, 1, 2, 3)]
    assert _same_bits(got, want[:4])


@pytest.mark.cuda
def test_bh_step_launches_near_once_inside_its_span():
    """A step of the nbody.bh131k cell's Experiment launches kernel N
    once, and the profiler puts that launch inside nbody.near."""
    from perfbench import profiling

    from test_torch_trace import _launch_chain

    dev = _card()
    exp = NBodyExperiment(dev)
    st = exp.init("orbits", 131_072)
    exp.step(st)
    launches = bh.near_field_cuda.launches
    exp.step(st)
    assert bh.near_field_cuda.launches == launches + 1
    session = profiling.profile_frames(lambda: exp.step(st), 2)
    near = [a for a in session.device if "::near_kernel(" in a.name]
    assert len(near) == session.frames == 2
    for act in near:
        assert "nbody.near" in _launch_chain(session, act)

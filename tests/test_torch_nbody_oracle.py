"""The port's Barnes-Hut step against the independent scalar C++ oracle
(ROADMAP A13): the accuracy class tests/test_ref_oracle.py holds the JAX
package to, on the port.

The oracle (tools/ref_oracle, built with g++ as tests/test_ref_oracle.py
builds it) steps the reference's quadtree Barnes-Hut and its brute force;
the brute force is the ground truth. The port's step_bh (Morton sort,
block Barnes-Hut, Euler, runaway kill) takes one step from the same
Morton-sorted initial conditions, JAX's stable_orbits(PRNGKey(0))
carried across as numpy, and its acceleration is read from the velocity
change, as the oracle's are.
"""

import os
import subprocess

import numpy as np
import jax
import pytest
import torch

from rustexp_tpu.sims.nbody import stable_orbits
from rustexp_tpu_torch.ops import nbody_bh

ORACLE_DIR = os.path.join(os.path.dirname(__file__), "..", "tools",
                          "ref_oracle")


@pytest.fixture(scope="module")
def oracle_bin(tmp_path_factory):
    """Build the oracle with the system g++ through its Makefile, into a
    directory of this test's own (tests/test_ref_oracle.py may build the
    one in tools/ref_oracle in another worker at the same time); skip if
    there is no toolchain."""
    out = tmp_path_factory.mktemp("ref_oracle")
    src = os.path.abspath(ORACLE_DIR)
    try:
        subprocess.run(["make", "-s", "-C", str(out), "-f",
                        os.path.join(src, "Makefile"),
                        f"--eval=vpath %.cpp {src}"],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        pytest.skip(f"cannot build ref oracle: {e}")
    return str(out / "oracle")


def _run(exe, *args):
    subprocess.run([exe, *[str(a) for a in args]], check=True, timeout=600)


def test_step_bh_accuracy_class(oracle_bin, tmp_path):
    """p90 (and median) relative acceleration error of the port's step_bh
    within 1.25x the reference quadtree's at theta 0.85, N = 16,384,
    block 128 (tests/test_ref_oracle.py test_oracle_bh_accuracy_class)."""
    n, block, theta, dt = 16384, 128, 0.85, 0.01
    arrays = [torch.from_numpy(np.array(a)) for a in
              stable_orbits(jax.random.PRNGKey(0), n)]
    px, py, vx, vy, m = arrays
    pxs, pys, ms, vxs, vys = nbody_bh.morton_sort(px, py, m, vx, vy)
    inter = torch.stack([pxs, pys, vxs, vys, ms], 1).numpy()
    p0, pbr, pbh = tmp_path / "p0", tmp_path / "pbr", tmp_path / "pbh"
    p0.write_bytes(inter.astype(np.float32).tobytes())
    _run(oracle_bin, "nbody_step", n, p0, 1, dt, pbr)
    _run(oracle_bin, "nbody_bh_step", n, p0, 1, theta, dt, pbh)
    br = np.frombuffer(pbr.read_bytes(), np.float32).reshape(n, 5)
    bh = np.frombuffer(pbh.read_bytes(), np.float32).reshape(n, 5)
    a_true = (br[:, 2:4] - inter[:, 2:4]) / dt
    a_ref = (bh[:, 2:4] - inter[:, 2:4]) / dt
    norm = np.linalg.norm(a_true, axis=1) + 1e-12

    k = nbody_bh.theta_to_k(theta, n // block)
    qx, qy, wx, wy, qm = nbody_bh.step_bh(pxs, pys, vxs, vys, ms, block, k,
                                          dt)
    # the sorted set stays in its order, so row i is particle i
    assert torch.equal(qm, ms)
    a_ours = (torch.stack([wx, wy], 1).numpy() - inter[:, 2:4]) / dt

    e_ref = np.linalg.norm(a_ref - a_true, axis=1) / norm
    e_ours = np.linalg.norm(a_ours - a_true, axis=1) / norm
    p90_ref = float(np.percentile(e_ref, 90))
    p90_ours = float(np.percentile(e_ours, 90))
    print(f"p90 port {p90_ours:.5f}, reference quadtree {p90_ref:.5f}")
    assert p90_ours <= max(p90_ref * 1.25, 0.01), (p90_ours, p90_ref)
    assert float(np.median(e_ours)) <= max(float(np.median(e_ref)) * 1.25,
                                           0.005)

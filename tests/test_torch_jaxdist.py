"""``repro_torch.jaxdist`` against the JAX package's, on the CPU: one gloo
group of 8 ranks (``tests/torch_jaxdist_ranks.py``, no JAX there) on a (2,
2, 2) mesh, the JAX side on ``tests/conftest.py``'s 8 virtual devices, with
the inputs of the reference's ``test_jaxdist_algorithms`` and
``test_jaxdist_cholesky3d`` (``tests/test_sharded.py``):

- ``matmul_3d``: C within 1e-4 of A B and of JAX's C; one local product a
  rank (a matmul launch), C laid out P('x', 'y');
- ``tsqr``: Q R and Q^T Q within 1e-4, |R| against JAX's |R| (the signs
  are LAPACK's choice), Q row-sharded over x, R replicated;
- ``cholesky_3d`` (n 32, block 8): L L^T and L L^{-1} within 2e-3, L and
  L^{-1} against JAX's.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JaxP

from repro.jaxdist import cholesky_3d, make_3d_mesh, matmul_3d, tsqr
import torch_jaxdist_ranks as R

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TOL, CHOL_TOL = 1e-4, 2e-3


def inputs():
    """The reference tests' draws, in their order."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 64)).astype(np.float32)
    B = rng.standard_normal((64, 16)).astype(np.float32)
    Am = rng.standard_normal((64, 8)).astype(np.float32)
    rng = np.random.default_rng(0)
    n = 32
    M = rng.standard_normal((n, n)).astype(np.float32)
    SPD = M @ M.T + n * np.eye(n, dtype=np.float32)
    return {"A": A, "B": B, "Am": Am, "SPD": SPD}


def jax_side(x):
    mesh = make_3d_mesh(2)

    def put(a, *spec):
        return jax.device_put(a, NamedSharding(mesh, JaxP(*spec)))
    C = jax.jit(lambda a, b: matmul_3d(a, b, mesh))(
        put(x["A"], "x", "z"), put(x["B"], "z", "y"))
    Q, R_ = jax.jit(lambda a: tsqr(a, mesh, "x"))(put(x["Am"], "x", None))
    L, Linv = jax.jit(lambda a: cholesky_3d(a, mesh, block=R.BLOCK))(
        put(x["SPD"], "x", "y"))
    return {k: np.asarray(v) for k, v in
            dict(C=C, Q=Q, R=R_, L=L, Linv=Linv).items()}


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    in_dir = tmp_path_factory.mktemp("jaxdist_in")
    out_dir = tmp_path_factory.mktemp("jaxdist_out")
    x = inputs()
    np.savez(in_dir / "inputs.npz", **x)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    log = open(out_dir / "ranks.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_jaxdist_ranks.py"), str(in_dir),
         str(out_dir)], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        want = jax_side(x)
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    if proc.returncode != 0 or not (out_dir / "done").exists():
        tail = (out_dir / "ranks.log").read_text()[-6000:]
        raise AssertionError(f"the 8 ranks failed (rc {proc.returncode}):\n"
                             f"{tail}")
    with np.load(out_dir / "jaxdist.npz") as z:
        port = {k: z[k] for k in z.files}
    return x, port, want


def test_matmul_3d(got):
    x, port, want = got
    np.testing.assert_allclose(port["C"], x["A"] @ x["B"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(port["C"], want["C"], rtol=TOL, atol=TOL)


def test_tsqr(got):
    x, port, want = got
    Q, R_ = port["Q"], port["R"]
    np.testing.assert_allclose(Q @ R_, x["Am"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(Q.T @ Q, np.eye(8), atol=TOL)
    np.testing.assert_allclose(np.abs(R_), np.abs(want["R"]), rtol=TOL,
                               atol=TOL)


def test_cholesky_3d(got):
    x, port, want = got
    L, Linv = port["L"], port["Linv"]
    n = L.shape[0]
    np.testing.assert_allclose(L @ L.T, x["SPD"], rtol=CHOL_TOL,
                               atol=CHOL_TOL)
    np.testing.assert_allclose(L @ Linv, np.eye(n), atol=CHOL_TOL)
    np.testing.assert_allclose(L, want["L"], rtol=CHOL_TOL, atol=CHOL_TOL)
    np.testing.assert_allclose(Linv, want["Linv"], rtol=CHOL_TOL,
                               atol=CHOL_TOL)


def test_layouts_and_products(got):
    """C and L in P('x', 'y') (Shard(0) on x, Shard(1) on y), Q row-sharded
    over x, R replicated; every product one matmul call on each rank: one
    for matmul_3d, one for tsqr and 12 for cholesky_3d (n 32, block 8:
    four 3D products at n 32 and four in each of its two n-16 halves)."""
    _, port, _ = got
    pl = dict(s.split(" ", 1) for s in port["placements"])
    xy = "(Shard(dim=0), Shard(dim=1), Replicate())"
    assert pl["C"] == xy and pl["L"] == xy and pl["Linv"] == xy
    assert pl["Q"] == "(Shard(dim=0), Replicate(), Replicate())"
    assert pl["R"] == "(Replicate(), Replicate(), Replicate())"
    assert list(port["calls"]) == [1 + 1 + 4 * 3] * R.WORLD

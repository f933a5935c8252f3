"""K12's parallel (round-robin) Jacobi order, on the CPU: the float32 NumPy
replica of the kernel's loop (``chip_smoke.py::jacobi_replica``, whose
rotation count is K12's bound in ``chip_smoke.py``) against the JAX
package's ``jnp.linalg.eigh`` and against float64.

The kernel itself (``csrc/linalg.cu``) runs only on a card
(``tests/test_torch_gpu_twoview_graph.py`` holds it to this replica bit
for bit); what these tests check is the order: its schedule (every pair
once a sweep, disjoint pairs a round), its convergence within MAX_SWEEPS,
and its accuracy on the two-view init's eight-point rows and RANSAC-H's
DLT rows: the eigenvalues within 1e-5 of each matrix's largest entry of
JAX's and float64's, and the least eigenvalue's vector (what the fits
take), where float64 pins it down, no farther from float64's than JAX's
eigh is plus EIG_MARGIN (as the GPU tests hold the kernel to cuSOLVER).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from _torch_threads import _one_torch_thread  # noqa: F401

EIG_MARGIN = 1e-4     # tests/test_torch_gpu_twoview_graph.py's


@pytest.fixture(scope="module")
def sets():
    return {"eight-point": cs.linalg_scene("cpu")[0].numpy(),
            "dlt": cs.linalg_dlt_scene("cpu").numpy()}


def _null_err(V, V64, apart):
    """Largest distance of V's first column from V64's, up to sign, over
    the matrices in `apart`."""
    d = np.minimum(np.abs(V[:, :, 0] - V64[:, :, 0]).max(1),
                   np.abs(V[:, :, 0] + V64[:, :, 0]).max(1))
    return float(d[apart].max())


@pytest.mark.parametrize("n", range(1, 10))
def test_round_robin_meets_every_pair_once_a_sweep(n):
    """n' - 1 rounds of n' / 2 disjoint pairs (n' = n padded to even); the
    real pairs of a sweep are every pair of the n indices once, and for odd
    n slot 0 of each round holds the bye (index n)."""
    rounds = cs.round_pairs(n)
    npad = n + (n & 1)
    assert len(rounds) == npad - 1 and all(len(r) == npad // 2 for r in rounds)
    for r in rounds:
        members = [i for pq in r for i in pq]
        assert sorted(members) == list(range(npad))
        assert all(p < q for p, q in r)
        if n % 2:
            assert r[0][1] == n
    real = [pq for r in rounds for pq in r if pq[1] < n]
    assert sorted(real) == [(p, q) for p in range(n) for q in range(p + 1, n)]


@pytest.mark.parametrize("name", ["eight-point", "dlt"])
def test_replica_against_jax_eigh_and_float64(sets, name):
    """The two-view init's (257, 9, 9) eight-point A^T A and RANSAC-H's DLT
    A^T A: every matrix converges within MAX_SWEEPS; eigenvalues within
    1e-5 of the largest entry of JAX's eigh and of float64; V orthonormal
    within 1e-5; the least eigenvalue's vector no farther from float64's
    than JAX's is plus EIG_MARGIN, on the matrices float64 pins down."""
    A = sets[name]
    r = cs.jacobi_replica(A)
    print(f"{name}: sweeps a matrix {np.bincount(r['sweeps']).tolist()} (index = sweeps), "
          f"{r['rotations']} rotations, {r['tests']} pairs tested")
    assert r["converged"].all() and int(r["sweeps"].max()) <= cs.MAX_SWEEPS
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    w64, V64 = np.linalg.eigh(A.astype(np.float64))
    scale = np.abs(A).max((1, 2))
    for want in (wj, w64):
        assert float((np.abs(r["w"] - want).max(1) / scale).max()) < 1e-5
    V = r["V"].astype(np.float64)
    assert float(np.abs(V.transpose(0, 2, 1) @ V - np.eye(9)).max()) < 1e-5
    apart = (w64[:, 1] - w64[:, 0]) > 1e-3 * scale
    e_k, e_j = _null_err(V, V64, apart), _null_err(Vj.astype(np.float64), V64, apart)
    print(f"{name}: least eigenvector from float64: replica {e_k:.3g}, JAX eigh {e_j:.3g} "
          f"on {int(apart.sum())} matrices")
    assert apart.sum() > 0 and e_k <= e_j + EIG_MARGIN


def test_replica_keeps_a_graded_matrix_least_vector():
    """Graded D B D matrices (eigenvalues ~1e-6 .. 1e3, B in a random
    basis): the relative threshold keeps the least eigenvector within 1e-5
    of float64's and the least eigenvalue to 1e-4 of itself, no farther
    than JAX's eigh plus EIG_MARGIN."""
    A = cs.graded_matrices(8)
    r = cs.jacobi_replica(A)
    assert r["converged"].all()
    w64, V64 = np.linalg.eigh(A.astype(np.float64))
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    everyone = np.ones(len(A), bool)
    e_k = _null_err(r["V"].astype(np.float64), V64, everyone)
    e_j = _null_err(Vj.astype(np.float64), V64, everyone)
    print(f"graded: least eigenvector from float64: replica {e_k:.3g}, JAX eigh {e_j:.3g}")
    assert e_k < 1e-5 and e_k <= e_j + EIG_MARGIN
    assert float((np.abs(r["w"][:, 0] - w64[:, 0]) / w64[:, 0]).max()) < 1e-4


def test_replica_zero_nan_batch_and_ops(sets):
    """A zero matrix makes no rotation (V = I, one sweep); a NaN or inf
    entry makes that matrix's outputs all NaN and leaves the others'
    bits; each matrix gives the same bits alone as in its batch; sizes 1-8
    on random symmetric matrices against JAX's eigh; jacobi_ops counts the
    replica's rotations and tests by K12's bound."""
    z = cs.jacobi_replica(np.zeros((2, 9, 9), np.float32))
    assert np.array_equal(z["V"], np.broadcast_to(np.eye(9), (2, 9, 9)))
    assert not z["w"].any() and z["sweeps"].tolist() == [1, 1] and z["rotations"] == 0
    A = sets["eight-point"][:6].copy()
    alone = [cs.jacobi_replica(A[i:i + 1]) for i in range(6)]
    whole = cs.jacobi_replica(A)
    for i, one in enumerate(alone):
        assert np.array_equal(one["w"][0], whole["w"][i]) and np.array_equal(one["V"][0],
                                                                          whole["V"][i])
    A[1, 3, 2] = np.nan
    A[2, 0, 0] = np.inf
    bad = cs.jacobi_replica(A)
    assert np.isnan(bad["w"][1:3]).all() and np.isnan(bad["V"][1:3]).all()
    for i in (0, 3, 4, 5):
        assert np.array_equal(bad["w"][i], whole["w"][i])
    rng = np.random.default_rng(3)
    for n in range(1, 9):
        B = rng.standard_normal((32, n, n)).astype(np.float32)
        S = B + B.transpose(0, 2, 1)
        r = cs.jacobi_replica(S)
        wj = np.asarray(jnp.linalg.eigh(jnp.asarray(S))[0])
        assert r["converged"].all()
        assert float((np.abs(r["w"] - wj).max(1) / np.abs(S).max((1, 2))).max()) < 1e-5, n
    r = cs.jacobi_replica(sets["dlt"])
    assert cs.jacobi_ops(sets["dlt"]) == r["rotations"] * (14 + 6 * 7 + 4 + 6 * 9) + 7 * r["tests"]

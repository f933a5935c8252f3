"""K13's one-sided Jacobi loop, on the CPU: the float32 NumPy replica of the
kernel (``chip_smoke.py::svd3_replica``, whose rotation and test counts are
K13's bound in ``chip_smoke.py``) against the JAX package's
``jnp.linalg.svd``, against float64, and against a plain serial loop.

The kernel itself (``csrc/linalg.cu``) runs only on a card
(``tests/test_torch_gpu_twoview_graph.py`` holds it to this replica bit
for bit). What these tests check is the loop: that testing a sweep's three
column pairs at once, then rotating them in turn, gives the bits of one
thread testing and rotating them in turn (``_serial_svd3``, the design it
replaced); its convergence within SVD_MAX_SWEEPS on the two-view init's
matrices; its accuracy on ``chip_smoke.svd3_sets`` with
``tests/test_torch_gpu_twoview_graph.py::_check_svd``'s bounds (S within
2e-6 of S[0], U and Vh orthonormal within 2e-6, A rebuilt within 4e-6 of
|A|, the rank-2 projection within 1e-4 where sigma_2 >= 1e-2 sigma_1);
zero, rank-1, NaN and inf inputs; and a matrix's bits alone and in a batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from _torch_threads import _one_torch_thread  # noqa: F401

ACCURATE = ("fits", "essential", "random", "rank2", "sigma110")
RANK2 = ("fits", "essential", "rank2", "sigma110")   # the init's kinds of matrix
F32 = np.float32


@pytest.fixture(scope="module")
def sets():
    return cs.svd3_sets()


@pytest.fixture(scope="module")
def replicas(sets):
    return {name: cs.svd3_replica(A) for name, A in sets.items()}


def _dot(x, y):
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def _serial_svd3(a):
    """One matrix in float32 NumPy scalars, as one thread ran K13 before:
    each sweep tests and rotates the pairs (0, 1), (0, 2), (1, 2) in turn
    (test |gamma| > eps sqrt(alpha) sqrt(beta), svd_angle's angle)
    and stops after a sweep with no rotation; the norms sorted by exchanges
    with their columns' norms taken again after the sort; U as K13's."""
    col = [[F32(a[k][j]) for k in range(3)] for j in range(3)]
    vc = [[F32(1.0 if j == k else 0.0) for k in range(3)] for j in range(3)]
    if not np.isfinite(np.asarray(a)).all():
        nan = np.full((3, 3), np.nan, F32)
        return nan, np.full(3, np.nan, F32), nan
    with np.errstate(all="ignore"):
        for _ in range(cs.SVD_MAX_SWEEPS):
            rotated = False
            for p, q in cs.SVD_PAIRS:
                alpha, beta = _dot(col[p], col[p]), _dot(col[q], col[q])
                gamma = _dot(col[p], col[q])
                if not abs(gamma) > cs.LINALG_EPS * np.sqrt(alpha) * np.sqrt(beta):
                    continue
                rotated = True
                theta = (beta - alpha) / (F32(2) * gamma)
                t = F32(1) / (abs(theta) + np.sqrt(theta * theta + F32(1)))
                t = -t if theta < 0 else t
                c = F32(1) / np.sqrt(t * t + F32(1))
                s = t * c
                for m in (col, vc):
                    x, y = m[p][:], m[q][:]
                    m[p] = [c * x[k] - s * y[k] for k in range(3)]
                    m[q] = [s * x[k] + c * y[k] for k in range(3)]
            if not rotated:
                break
        key = [np.sqrt(_dot(col[j], col[j])) for j in range(3)]
        for i, j in ((0, 1), (1, 2), (0, 1)):
            if key[j] > key[i]:
                col[i], col[j], vc[i], vc[j] = col[j], col[i], vc[j], vc[i]
                key[i], key[j] = key[j], key[i]
        sig = [np.sqrt(_dot(col[j], col[j])) for j in range(3)]
        u0 = [x / sig[0] for x in col[0]] if sig[0] > 0 else [F32(1), F32(0), F32(0)]
        g = _dot(col[1], u0)
        u1 = [col[1][k] - g * u0[k] for k in range(3)]
        n2 = np.sqrt(_dot(u1, u1))
        if not n2 > 0:
            m = [abs(x) for x in u0]
            e = 0 if (m[0] <= m[1] and m[0] <= m[2]) else (1 if m[1] <= m[2] else 2)
            u1 = [F32(1.0 if k == e else 0.0) - u0[e] * u0[k] for k in range(3)]
            n2 = np.sqrt(_dot(u1, u1))
        u1 = [x / n2 for x in u1]
        u2 = [u0[1] * u1[2] - u0[2] * u1[1], u0[2] * u1[0] - u0[0] * u1[2],
              u0[0] * u1[1] - u0[1] * u1[0]]
        if _dot(u2, col[2]) < 0:
            u2 = [-x for x in u2]
    zero = F32(0)
    U = np.array([u0, u1, u2], F32).T + zero
    return U, np.array(sig, F32) + zero, np.array(vc, F32) + zero


def _svd_errors(A, U, S, Vh, Sw):
    """(S's distance from Sw over Sw[0], U's and Vh's distance from
    orthonormal, A's rebuilt distance over Sw[0]), largest of the batch,
    in float64."""
    U, S, Vh, A = (x.astype(np.float64) for x in (U, S, Vh, A))
    scale = Sw[:, 0].astype(np.float64)
    err_s = float((np.abs(S - Sw).max(1) / scale).max())
    eye = np.eye(3)
    ortho = max(float(np.abs(np.swapaxes(U, 1, 2) @ U - eye).max()),
                float(np.abs(Vh @ np.swapaxes(Vh, 1, 2) - eye).max()))
    rebuilt = float((np.abs((U * S[:, None, :]) @ Vh - A).max((1, 2)) / scale).max())
    return err_s, ortho, rebuilt


def _projection(U, Vh):
    U, Vh = U.astype(np.float64), Vh.astype(np.float64)
    return (U * [1.0, 1.0, 0.0]) @ Vh


@pytest.mark.parametrize("name", ACCURATE)
def test_replica_against_jax_svd_and_float64(sets, replicas, name):
    """On each of chip_smoke's sets (the init's 257 fits, their essential
    projections, 4096 random, 4096 rank-2 and 1024 sigma = (1, 1, 0)
    matrices): S within 2e-6 of S[0] of JAX's svd and of float64's, U and
    Vh orthonormal within 2e-6, A rebuilt within 4e-6 of |A|; on the rank-2
    sets the projection U diag(1, 1, 0) Vh within 1e-4 of JAX's and of
    float64's where sigma_2 >= 1e-2 sigma_1; every matrix of the init's
    sets converges below SVD_MAX_SWEEPS (random matrices may end on a
    rounding-level two-cycle at SVD_MAX_SWEEPS and meet the same bounds)."""
    A, r = sets[name], replicas[name]
    Uj, Sj, Vhj = (np.asarray(x) for x in jnp.linalg.svd(jnp.asarray(A)))
    U64, S64, Vh64 = np.linalg.svd(A.astype(np.float64))
    capped = int((~r["converged"]).sum())
    print(f"{name}: sweeps a matrix {np.bincount(r['sweeps']).tolist()} (index = sweeps), "
          f"{r['rotations']} rotations, {r['tests']} pairs tested, {capped} at SVD_MAX_SWEEPS")
    assert int(r["sweeps"].max()) <= cs.SVD_MAX_SWEEPS
    if name in RANK2:
        assert r["converged"].all() and int(r["sweeps"].max()) < cs.SVD_MAX_SWEEPS
    for want in (Sj, S64):
        err_s, ortho, rebuilt = _svd_errors(A, r["U"], r["S"], r["Vh"], want)
        print(f"{name}: S {err_s:.3g} of S[0], orthonormal {ortho:.3g}, rebuilt {rebuilt:.3g}")
        assert err_s < 2e-6 and ortho < 2e-6 and rebuilt < 4e-6, (err_s, ortho, rebuilt)
    if name in RANK2:
        apart = S64[:, 1] >= 1e-2 * S64[:, 0]
        got = _projection(r["U"], r["Vh"])[apart]
        for U, Vh in ((Uj, Vhj), (U64, Vh64)):
            err = float(np.abs(got - _projection(U, Vh)[apart]).max())
            assert apart.sum() > 0 and err < 1e-4, err


@pytest.mark.parametrize("name", ["fits", "essential", "random", "rank2", "sigma110",
                                  "degenerate"])
def test_replica_is_the_serial_loop(sets, replicas, name):
    """Testing a sweep's three pairs at once, then rotating them in turn,
    and the norms taken once and moved with their columns, give the bits of
    one thread testing and rotating each pair in turn and taking the norms
    again after the sort (on up to 384 matrices of each set)."""
    A, r = sets[name], replicas[name]
    for i in range(min(len(A), 384)):
        U, S, Vh = _serial_svd3(A[i])
        assert cs.bits_equal(U, r["U"][i]) and cs.bits_equal(S, r["S"][i]), (name, i)
        assert cs.bits_equal(Vh, r["Vh"][i]), (name, i)


@pytest.mark.parametrize("name", ["fits", "random", "rank2", "degenerate"])
def test_replica_matrix_alone_equals_batch(sets, replicas, name):
    """Each of a set's first 64 matrices gives the same bits alone as in
    its batch."""
    A, r = sets[name], replicas[name]
    for i in range(min(len(A), 64)):
        one = cs.svd3_replica(A[i:i + 1])
        for key in ("U", "S", "Vh"):
            assert cs.bits_equal(one[key][0], r[key][i]), (name, i, key)


def test_replica_zero_and_special_matrices():
    """A zero matrix makes no rotation (one sweep) and gives U = Vh = I, S
    = 0; I, diag(3, 3, 3) and diag(1, 2, 3) keep their order (the exchange
    is stable); an exact essential matrix gives S = (1, 1, 0), U's third
    column the cross product; -0 entries give no -0 in the outputs."""
    z = cs.svd3_replica(np.zeros((2, 3, 3), F32))
    eye = np.broadcast_to(np.eye(3, dtype=F32), (2, 3, 3))
    assert cs.bits_equal(z["U"], eye) and cs.bits_equal(z["Vh"], eye)
    assert not z["S"].any() and z["sweeps"].tolist() == [1, 1] and z["rotations"] == 0
    d = cs.svd3_replica(np.stack([np.eye(3), np.diag([3.0, 3, 3]), np.diag([1.0, 2, 3]),
                                  -np.eye(3)]).astype(F32))
    assert d["S"].tolist() == [[1, 1, 1], [3, 3, 3], [3, 2, 1], [1, 1, 1]]
    assert cs.bits_equal(d["Vh"][:2], np.broadcast_to(np.eye(3, dtype=F32), (2, 3, 3)))
    assert cs.bits_equal(d["Vh"][2], np.eye(3, dtype=F32)[::-1])
    assert cs.bits_equal(d["U"][3], -np.eye(3, dtype=F32) + F32(0))
    hat = np.array([[[0, -1, 0], [1, 0, 0], [0, 0, -0.0]]], F32)
    e = cs.svd3_replica(hat)
    assert e["S"].tolist() == [[1, 1, 0]] and e["converged"].all()
    U = e["U"][0].astype(np.float64)
    assert np.allclose(U[:, 2], np.cross(U[:, 0], U[:, 1]), atol=1e-7)
    assert np.allclose((e["U"][0] * e["S"][0]) @ e["Vh"][0], hat[0], atol=1e-7)
    for key in ("U", "S", "Vh"):
        for out in (d, e):
            assert not np.signbit(out[key][out[key] == 0]).any(), key


def test_replica_rank1_and_degenerate_columns(sets, replicas):
    """Rank-1 outer products: S[1:] within 2e-6 of S[0] of zero, U
    orthonormal (its second column from the least-along fallback where the
    second column vanishes), A rebuilt within 4e-6; a zero column or row
    and random matrices scaled to 1e-17 and 1e15 (their norms outside the
    kernel's fast paths) and with columns scaled (1, 1e-10, 1e-20) meet
    _check_svd's bounds against float64."""
    A, r = sets["degenerate"], replicas["degenerate"]
    rank1 = slice(12, 28)
    S64 = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert float((r["S"][rank1, 1:] / r["S"][rank1, :1]).max()) < 2e-6
    for part in (rank1, slice(28, 36), slice(36, 44), slice(44, 52), slice(60, 68),
                 slice(68, 76)):
        err_s, ortho, rebuilt = _svd_errors(A[part], r["U"][part], r["S"][part],
                                            r["Vh"][part], S64[part])
        assert err_s < 2e-6 and ortho < 2e-6 and rebuilt < 4e-6, (part, err_s, ortho, rebuilt)


@pytest.mark.parametrize("where, value", [((1, 2, 0), np.nan), ((2, 1, 1), -np.inf),
                                          ((0, 0, 0), np.inf)])
def test_replica_nan_and_inf(sets, where, value):
    """A matrix with a NaN or an inf entry gives NaN in every output, makes
    no sweep, and leaves the other matrices' bits."""
    A = sets["fits"][:4].copy()
    alone = cs.svd3_replica(A)
    A[where] = value
    r = cs.svd3_replica(A)
    b = where[0]
    assert all(np.isnan(r[key][b]).all() for key in ("U", "S", "Vh")) and r["sweeps"][b] == 0
    for i in set(range(4)) - {b}:
        assert all(cs.bits_equal(r[key][i], alone[key][i]) for key in ("U", "S", "Vh"))


def test_svd3_ops_counts_the_replica(sets, replicas):
    """svd3_ops is K13's bound's operation count from the replica's
    rotations and tests: 50 a rotation, 20 a pair tested, 60 a matrix."""
    for name in ("fits", "degenerate"):
        A, r = sets[name], replicas[name]
        assert cs.svd3_ops(A) == r["rotations"] * 50 + 20 * r["tests"] + 60 * len(A)
        assert r["tests"] >= 3 * int(r["sweeps"].sum())

"""The two-view init as a CUDA graph on a card (skipped without one), and
the two kernels that make it capturable: K12 (``sym_eig_small``, batched
Jacobi eigen-decomposition of symmetric n x n, n <= 9) and K13 (``svd3``,
batched one-sided Jacobi 3 x 3 SVD), held against their plain versions
(``torch.linalg.eigh``, ``torch.linalg.svd``) on the card;
``initialize_two_view`` replaying ``sfm.twoview.TWOVIEW_GRAPHS`` against
its eager function bit for bit; and whole IncrementalSfM runs replayed
against eager.

K12's layout (one warp a matrix, four a block: batches that leave a
block part-full, a matrix alone against the same matrix in a batch) and
its round-robin loop (its float32 replica's bits, its sweeps) are held
too; so are K13's (one thread a matrix, 32 a block staged through shared
memory; its one-sided loop, a sweep's pairs tested at once, bit for bit
against chip_smoke.py::svd3_replica on every set of chip_smoke.svd3_sets).

Eigenvector and singular-vector signs differ between the kernels and
cuSOLVER, and within a repeated eigenvalue (an essential matrix's sigma_1
= sigma_2) so does the basis: vectors are compared up to sign, repeated
eigenvalues by their subspace's projector, E's decomposition as a set.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_twoview_graph.py -q
"""

import importlib
import time

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.ops.kernels import linalg
from sift_pyocl_tpu_torch.sfm import IncrementalSfM
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm import geometry as tg
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import pnp as tpnp
from sift_pyocl_tpu_torch.sfm import twoview as ttv
from sift_pyocl_tpu_torch.utils import graphs
from sift_pyocl_tpu_torch.utils.render3d import render_sequence

from test_torch_gpu_api_graph import _eager_sfm
from test_torch_gpu_sfm_graph import KW as REG_KW, _map_scene, _register_args

# the module, not the `ransac` function the sfm package exports
tr = importlib.import_module("sift_pyocl_tpu_torch.sfm.ransac")
pytestmark = pytest.mark.gpu
SMALL = SiftConfig(kp_per_octave_cap=256)
CACHES = (ttv.TWOVIEW_GRAPHS, tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS, tpnp.PNP_GRAPHS,
          tpipe.PAIR_GRAPHS, tba.LM_GRAPHS, tpipe.BOOT_PROBE_GRAPHS, tpipe.LOOP_PROBE_GRAPHS)
# K12 against float64: no farther than torch.linalg.eigh (f32, cuSOLVER) is,
# plus this margin (the null vector of an 8-point A^T A in f32 lies ~1e-4
# from float64's for either)
EIG_MARGIN = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for c in CACHES:
        c.clear()
    yield torch.device("cuda", 0)
    for c in CACHES:
        c.clear()


def essential_scene(n=150, outliers=45, seed=1):
    """tests/test_ransac.py's essential scene (150 points, 45 outliers):
    K, pixels in both views, the K-normalized (x, y), the true inliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3))
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1.0]])
    R2 = tg.so3_exp(torch.tensor([0.03, -0.25, 0.02], dtype=torch.float64)).numpy()
    t2 = np.array([-0.8, 0.1, 0.05])
    Kt = torch.from_numpy(K)
    uv1 = tg.project(Kt, torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64),
                     torch.from_numpy(X))[0].numpy()
    uv2 = tg.project(Kt, torch.from_numpy(R2), torch.from_numpy(t2), torch.from_numpy(X))[0].numpy()
    uv2 = uv2 + rng.normal(0, 0.3, uv2.shape)
    out = rng.choice(n, outliers, replace=False)
    uv2[out] = rng.uniform(0, 300, (outliers, 2))
    gt_in = np.ones(n, bool)
    gt_in[out] = False
    K, uv1, uv2 = (a.astype(np.float32) for a in (K, uv1, uv2))
    xy1, xy2 = (tg.backproject(torch.from_numpy(K), torch.from_numpy(u))[:, :2].numpy()
                for u in (uv1, uv2))
    return K, uv1, uv2, xy1, xy2, gt_in


def homography_scene():
    """tests/test_ransac.py's homography scene (120 points, 35 % outliers)."""
    rng = np.random.default_rng(0)
    H = np.array([[1.05, 0.02, 5.0], [-0.01, 0.98, -3.0], [5e-5, -1e-4, 1.0]])
    p1 = rng.uniform(0, 300, (120, 2))
    ph = np.concatenate([p1, np.ones((120, 1))], 1) @ H.T
    p2 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.3, (120, 2))
    out = rng.choice(120, 42, replace=False)
    p2[out] = rng.uniform(0, 300, (42, 2))
    gt_in = np.ones(120, bool)
    gt_in[out] = False
    return p1.astype(np.float32), p2.astype(np.float32), gt_in


def _vec_err(got, want):
    """Largest distance between columns, each up to sign: (B, n) columns
    of (B, n, n) -> (B,)."""
    return torch.minimum((got - want).abs().amax(-2), (got + want).abs().amax(-2))


def _check_eig(A, tag):
    """K12 on the card against torch.linalg.eigh (f32, card) and float64:
    eigenvalues within 1e-5 of the largest's magnitude, V orthonormal
    within 1e-5 and A V = V diag(w) within 2e-5 |A|; and, on the matrices
    whose least eigenvalue is apart from the next by 1e-3 |A| (a null
    vector float64 pins down), that eigenvalue's vector (what the fits
    take) no farther from float64's than eigh's is plus EIG_MARGIN.
    Returns (K12's largest distance, eigh's, matrices compared)."""
    w, V = linalg.sym_eig_small(A)
    wp, Vp = linalg.sym_eig_small(A, plain=True)
    w64, V64 = torch.linalg.eigh(A.double())
    scale = A.abs().amax((-1, -2))
    assert float(((w - wp).abs().amax(-1) / scale).max()) < 1e-5, tag
    assert bool((w[..., 1:] >= w[..., :-1]).all()), tag
    eye = torch.eye(A.shape[-1], device=A.device)
    assert float((V.transpose(-1, -2) @ V - eye).abs().max()) < 1e-5, tag
    res = (A @ V - V * w[..., None, :]).abs().amax((-1, -2)) / scale
    assert float(res.max()) < 2e-5, tag
    if A.shape[-1] == 1:
        return 0.0, 0.0, 0
    apart = (w64[..., 1] - w64[..., 0]) > 1e-3 * scale
    e_k = _vec_err(V.double(), V64)[..., 0][apart]
    e_p = _vec_err(Vp.double(), V64)[..., 0][apart]
    out = (float(e_k.max()), float(e_p.max()), int(apart.sum()))
    assert out[2] > 0 and out[0] <= out[1] + EIG_MARGIN, (tag, out)
    return out


def test_sym_eig_small_eight_point_and_dlt_rows(cuda):
    """K12 on the (257, 9, 9) A^T A of 256 eight-point rows and the
    inliers' refit, and on the DLT rows of 256 four-point samples and their
    refit: _check_eig's bounds, one launch a call, the same bits on two
    calls."""
    _, _, _, xy1, xy2, gt_in = essential_scene()
    valid = torch.ones(len(gt_in), dtype=torch.bool)
    rows = tr._sample_weights(3, valid, 256, 8)
    W = torch.cat([torch.from_numpy(gt_in)[None].float(), rows])
    A = tg._eight_point_normal(torch.from_numpy(xy1), torch.from_numpy(xy2), W)[0].to(cuda)
    before = linalg.sym_eig_small.launches
    print("8-point K12 / eigh from f64:", _check_eig(A, "8-point"))
    assert linalg.sym_eig_small.launches == before + 1
    a, b = linalg.sym_eig_small(A), linalg.sym_eig_small(A)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    p1, p2, gt_h = homography_scene()
    rows = tr._sample_weights(4, torch.ones(120, dtype=torch.bool), 256, 4)
    W = torch.cat([torch.from_numpy(gt_h)[None].float(), rows])
    A = tg._dlt_normal(torch.from_numpy(p1), torch.from_numpy(p2), W)[0].to(cuda)
    print("DLT K12 / eigh from f64:", _check_eig(A, "DLT"))


def _eight_point_set(count, seed=3):
    """The essential scene's (count + 1, 9, 9) eight-point A^T A: the true
    inliers' refit, then `count` drawn eight-point rows."""
    _, _, _, xy1, xy2, gt_in = essential_scene()
    rows = tr._sample_weights(seed, torch.ones(len(gt_in), dtype=torch.bool), count, 8)
    W = torch.cat([torch.from_numpy(gt_in)[None].float(), rows])
    return tg._eight_point_normal(torch.from_numpy(xy1), torch.from_numpy(xy2), W)[0]


@pytest.mark.parametrize("n", [9, 8])
def test_sym_eig_small_batches_alone_and_part_full_blocks(cuda, n):
    """K12's layout (one warp a matrix, four a block) at batches of 1, 2,
    257 and 4097 (blocks part-full at 1, 2 and 257) on eight-point A^T A
    (n = 8: their leading 8 x 8): _check_eig's bounds at each batch, one
    launch a call, and every matrix of the 257 the same bits alone as in
    the batch."""
    A = _eight_point_set(4096)[..., :n, :n].contiguous().to(cuda)
    for B in (1, 2, 257, 4097):
        before = linalg.sym_eig_small.launches
        print(f"n = {n}, batch {B}: K12 / eigh from f64:", _check_eig(A[:B], f"{n}, {B}"))
        assert linalg.sym_eig_small.launches == before + 1
    w, V = linalg.sym_eig_small(A[:257])
    for i in range(257):
        wi, Vi = linalg.sym_eig_small(A[i:i + 1])
        assert torch.equal(wi[0], w[i]) and torch.equal(Vi[0], V[i]), i


def test_sym_eig_small_is_its_replica_and_converges(cuda):
    """K12 gives the bits of its loop's float32 replica
    (chip_smoke.py::jacobi_replica, whose rotations are K12's bound) on
    chip_smoke's two-view rows, RANSAC-H's DLT rows and their leading 8 x 8
    blocks; the replica ends every one of those matrices on a sweep with no
    rotation, below MAX_SWEEPS, so the kernel does too."""
    import chip_smoke as cs

    sets = {"eight-point": cs.linalg_scene("cpu")[0], "dlt": cs.linalg_dlt_scene("cpu")}
    for name, A in list(sets.items()):
        sets[f"{name} 8 x 8"] = A[..., :8, :8].contiguous()
    for name, A in sets.items():
        r = cs.jacobi_replica(A.numpy())
        w, V = (x.cpu().numpy() for x in linalg.sym_eig_small(A.to(cuda)))
        print(f"{name}: sweeps {np.bincount(r['sweeps']).tolist()}")
        assert r["converged"].all() and int(r["sweeps"].max()) < cs.MAX_SWEEPS, name
        assert np.array_equal(w, r["w"]) and np.array_equal(V, r["V"]), name


def test_sym_eig_small_graded_matrix_least_vector(cuda):
    """Graded D B D matrices (chip_smoke.graded_matrices: eigenvalues ~1e-6
    .. 1e3, B in a random basis): K12's least eigenvector no farther from
    float64's than eigh's is plus EIG_MARGIN, and within 1e-5 (the relative
    threshold's accuracy)."""
    import chip_smoke as cs

    A = torch.from_numpy(cs.graded_matrices(8)).to(cuda)
    _, V = linalg.sym_eig_small(A)
    _, Vp = linalg.sym_eig_small(A, plain=True)
    _, V64 = torch.linalg.eigh(A.double())
    e_k = float(_vec_err(V.double(), V64)[:, 0].max())
    e_p = float(_vec_err(Vp.double(), V64)[:, 0].max())
    print(f"graded: least eigenvector from float64: K12 {e_k:.3g}, eigh {e_p:.3g}")
    assert e_k < 1e-5 and e_k <= e_p + EIG_MARGIN


def _projector(V, w, value, tol):
    """The projector onto the span of V's columns whose eigenvalue lies
    within tol of value."""
    sel = V[:, (w - value).abs() < tol]
    return sel @ sel.T


def test_sym_eig_small_zero_repeated_and_small_sizes(cuda):
    """A zero matrix gives w = 0 and V = I (column 0 e0, as LAPACK gives);
    a matrix of eigenvalues (1, 1, 1, 2, 2, 3, 4, 5, 6) in a random basis
    gives each repeated value's subspace (projectors within 1e-5 of
    eigh's); n = 1 to 9 on random symmetric matrices within _check_eig's
    bounds; only the lower triangle is read."""
    w, V = linalg.sym_eig_small(torch.zeros((2, 9, 9), device=cuda))
    assert torch.equal(w, torch.zeros_like(w))
    assert torch.equal(V, torch.eye(9, device=cuda).expand(2, 9, 9))
    gen = torch.Generator().manual_seed(0)
    Q = torch.linalg.qr(torch.randn((9, 9), generator=gen, dtype=torch.float64))[0]
    lam = torch.tensor([1, 1, 1, 2, 2, 3, 4, 5, 6], dtype=torch.float64)
    A = ((Q * lam) @ Q.T).float().to(cuda)
    w, V = linalg.sym_eig_small(A)
    wp, Vp = linalg.sym_eig_small(A, plain=True)
    assert float((w - wp).abs().max()) < 1e-5
    for value in (1.0, 2.0):
        err = (_projector(V, w, value, 0.5) - _projector(Vp, wp, value, 0.5)).abs().max()
        assert float(err) < 1e-5, value
    for n in range(1, 10):
        B = torch.randn((64, n, n), generator=gen)
        _check_eig((B + B.transpose(-1, -2)).to(cuda), f"n = {n}")
    B = torch.randn((16, 9, 9), generator=gen)
    S = B.tril() + B.tril(-1).transpose(-1, -2)
    got = linalg.sym_eig_small(B.to(cuda))
    want = linalg.sym_eig_small(S.to(cuda))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sym_eig_small_nan_and_inf_return(cuda):
    """A matrix with a NaN or an inf entry in a batch returns within a
    second, its results all NaN, and the other matrices' results the bits
    they have alone; K13 likewise."""
    gen = torch.Generator().manual_seed(1)
    B = torch.randn((4, 9, 9), generator=gen)
    A = (B + B.transpose(-1, -2)).to(cuda)
    alone = linalg.sym_eig_small(A)
    bad = A.clone()
    bad[1, 3, 2] = bad[1, 2, 3] = float("nan")
    bad[2, 0, 0] = float("inf")
    torch.cuda.synchronize()
    t = time.perf_counter()
    w, V = linalg.sym_eig_small(bad)
    torch.cuda.synchronize()
    assert time.perf_counter() - t < 1.0
    for b in (0, 3):
        assert torch.equal(w[b], alone[0][b]) and torch.equal(V[b], alone[1][b])
    for b in (1, 2):
        assert bool(w[b].isnan().all() and V[b].isnan().all()), b
    M = A[..., :3, :3].contiguous()
    alone = linalg.svd3(M)
    bad = M.clone()
    bad[1, 2, 0] = float("nan")
    bad[2, 1, 1] = float("-inf")
    out = linalg.svd3(bad)
    for b in (0, 3):
        assert all(torch.equal(o[b], a[b]) for o, a in zip(out, alone))
    for b in (1, 2):
        assert all(bool(o[b].isnan().all()) for o in out), b


def _check_svd(A, tag, rank2=False):
    """K13 on the card against torch.linalg.svd (card): S within 2e-6 of
    S[0] (the plain version's), U and Vh orthonormal within 2e-6, U diag(S)
    Vh within 4e-6 |A| of A; with `rank2`, U diag(1, 1, 0) Vh (the
    essential projection) within 1e-4 of the plain version's where
    sigma_2 >= 1e-2 sigma_1 (the projection is ill-posed below)."""
    U, S, Vh = linalg.svd3(A)
    Up, Sp, Vhp = linalg.svd3(A, plain=True)
    scale = Sp[..., :1]
    assert float(((S - Sp).abs() / scale).max()) < 2e-6, tag
    eye = torch.eye(3, device=A.device)
    for M in (U.transpose(-1, -2) @ U, Vh @ Vh.transpose(-1, -2)):
        assert float((M - eye).abs().max()) < 2e-6, tag
    rec = ((U * S[..., None, :]) @ Vh - A).abs().amax((-1, -2)) / scale[..., 0]
    assert float(rec.max()) < 4e-6, tag
    if rank2:
        def proj(u, vh):
            return torch.cat([u[..., :2], torch.zeros_like(u[..., 2:])], -1) @ vh
        apart = Sp[..., 1] >= 1e-2 * Sp[..., 0]
        err = (proj(U, Vh) - proj(Up, Vhp)).abs().amax((-1, -2))[apart]
        assert int(apart.sum()) > 0 and float(err.max()) < 1e-4, tag


def test_svd3_random_rank2_and_essential(cuda):
    """K13 on 4096 random matrices, 4096 rank-2 ones (sigma_3 = 0 made in
    float64, sigma_2 / sigma_1 in [0.1, 1]), the 257 rank-2 8-point fits of the essential scene, and
    essential matrices (sigma_1 = sigma_2): _check_svd's bounds; the
    essential decomposition's four candidates on the card (K13) equal the
    CPU's (LAPACK) as a set within 1e-4 (rotations, t up to sign), and
    U's third column is a unit vector; one launch a call."""
    gen = torch.Generator().manual_seed(2)
    A = torch.randn((4096, 3, 3), generator=gen, dtype=torch.float64)
    _check_svd(A.float().to(cuda), "random")
    U, S, Vh = torch.linalg.svd(A)
    S[:, 1] = S[:, 0] * (0.1 + 0.9 * torch.rand(4096, generator=gen, dtype=torch.float64))
    S[:, 2] = 0
    A2 = ((U * S[:, None, :]) @ Vh).float().to(cuda)
    _check_svd(A2, "rank 2", rank2=True)
    _, _, _, xy1, xy2, gt_in = essential_scene()
    rows = tr._sample_weights(5, torch.ones(len(gt_in), dtype=torch.bool), 256, 8)
    W = torch.cat([torch.from_numpy(gt_in)[None].float(), rows])
    F = tg.fit_fundamental_8pt(*(torch.from_numpy(a).to(cuda) for a in (xy1, xy2)), W.to(cuda))
    _check_svd(F, "8-point fits", rank2=True)
    E = tg.essential_from_fundamental(F, torch.eye(3, device=cuda), torch.eye(3, device=cuda))
    _check_svd(E, "essential", rank2=True)
    before = linalg.svd3.launches
    for b in (0, 1, 100):
        Rs, ts = tg.decompose_essential(E[b])
        Rc, tc = tg.decompose_essential(E[b].cpu())
        for R in Rs.cpu():
            assert min(float((R - r).abs().max()) for r in Rc) < 1e-4, b
        for t in ts.cpu():
            assert min(float((t - s * u).abs().max()) for u in tc for s in (1, -1)) < 1e-4, b
            assert abs(float(t.norm()) - 1) < 1e-6
    assert linalg.svd3.launches == before + 3


SVD3_SETS = ("device fits", "fits", "essential", "random", "rank2", "sigma110", "degenerate",
             "nan and inf")


def _svd3_set(name, cuda):
    """chip_smoke's K13 inputs by name: svd3_sets, the fits' null vectors
    from torch.linalg.eigh on the card (as chip_smoke's check takes them),
    or the fits with NaN and inf entries."""
    import chip_smoke as cs

    if name == "device fits":
        A = cs.linalg_scene(cuda)[0]
        return linalg.sym_eig_small(A, plain=True)[1][:, :, 0].reshape(-1, 3, 3).cpu().numpy()
    if name == "nan and inf":
        A = cs.svd3_sets()["fits"][:40].copy()
        A[3, 1, 2], A[7, 0, 0], A[8, 2, 2], A[33, 1, 1] = np.nan, np.inf, -np.inf, np.nan
        return A
    return cs.svd3_sets()[name]


@pytest.mark.parametrize("name", SVD3_SETS)
def test_svd3_is_its_replica(cuda, name):
    """K13 gives the bits of its loop's float32 replica
    (chip_smoke.py::svd3_replica, whose rotations and tests are K13's
    bound) on each of chip_smoke's sets: the init's fits (null vectors from
    the card's eigh and the CPU's), their essential projections, random,
    rank-2 and sigma = (1, 1, 0) matrices, degenerate ones (zero, rank 1,
    zero columns and rows, scales whose norms leave the fast paths'
    ranges) and fits with NaN and inf entries (all NaN, the rest their
    bits); the replica ends every matrix of the init's sets below
    SVD_MAX_SWEEPS, so the kernel does too; one launch a call."""
    import chip_smoke as cs

    A = _svd3_set(name, cuda)
    r = cs.svd3_replica(A)
    before = linalg.svd3.launches
    got = [x.cpu().numpy() for x in linalg.svd3(torch.from_numpy(A).to(cuda))]
    assert linalg.svd3.launches == before + 1
    print(f"{name}: sweeps {np.bincount(r['sweeps']).tolist()}, "
          f"{int((~r['converged']).sum())} at SVD_MAX_SWEEPS")
    for g, key in zip(got, ("U", "S", "Vh")):
        assert cs.bits_equal(g, r[key]), (name, key)
    if name in ("device fits", "fits", "essential", "rank2", "sigma110"):
        assert r["converged"].all() and int(r["sweeps"].max()) < cs.SVD_MAX_SWEEPS


def test_svd3_batch_one_and_part_full_blocks(cuda):
    """K13 (32 matrices a block) at batches 1, 2, 31, 32, 33, 65 and 257
    gives each matrix the bits it has in a batch of 4096 random matrices
    (the last block part-full), and each of the first 40 alone the same;
    the fits likewise, alone and in their batch of 257."""
    import chip_smoke as cs

    sets = cs.svd3_sets()
    for name in ("random", "fits"):
        A = torch.from_numpy(sets[name]).to(cuda)
        whole = linalg.svd3(A)
        for B in (1, 2, 31, 32, 33, 65, 257):
            part = linalg.svd3(A[:B].contiguous())
            assert all(torch.equal(p, w[:B]) for p, w in zip(part, whole)), (name, B)
        for i in range(40):
            one = linalg.svd3(A[i:i + 1].contiguous())
            assert all(torch.equal(o[0], w[i]) for o, w in zip(one, whole)), (name, i)


def _padded(uv1, uv2, P):
    n = len(uv1)
    return (tpipe._pad_rows(uv1, P, np.float32), tpipe._pad_rows(uv2, P, np.float32),
            np.arange(P) < n)


def _same(got, want):
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def test_two_view_replay_equals_eager_interleaved(cuda):
    """initialize_two_view on the card at buckets 256 and 512 (the 150
    matches padded with a valid mask), seeds 0 and 1, and with rows given:
    one graph a (bucket, rows given) key, each replay bit-equal to
    _initialize_two_view_eager on the same inputs, its fields views of one
    buffer; replays interleaved with REGISTER_GRAPHS and BOOT_PROBE_GRAPHS
    replays, on the current stream and a side stream, each equal to its
    eager call; a second call of a key captures nothing; the pose near the
    truth (most true inliers kept)."""
    K, uv1, uv2, _, _, gt_in = essential_scene()
    scene = _map_scene(cuda)
    b0, b1, b2 = scene[3]
    boot = (b0.desc, b0.valid, torch.stack([b0.x, b0.y], -1), torch.stack([b1.desc, b2.desc]),
            torch.stack([b1.valid, b2.valid]),
            torch.stack([torch.stack([b.x, b.y], -1) for b in (b1, b2)]))
    Kt = torch.from_numpy(K).to(cuda)
    reg_args = _register_args(scene, 256)
    want_reg = tpipe._register_from_buffers_eager(*reg_args, **REG_KW)
    want_boot = tpipe._boot_probe_eager(*boot)
    side = torch.cuda.Stream(cuda)
    before = ttv.TWOVIEW_GRAPHS.captures
    for i, (P, seed, given) in enumerate([(256, 0, False), (512, 1, False), (256, 1, False),
                                          (512, 0, True), (256, 0, False)]):
        a1, a2, v = _padded(uv1, uv2, P)
        rows = tr._sample_weights(seed + 9, torch.from_numpy(v), 256, 8).numpy() if given \
            else None
        stream = side if i % 2 else torch.cuda.current_stream(cuda)
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            got = ttv.initialize_two_view(seed, Kt, a1, a2, v, thresh_px=2.0, weights=rows)
            reg = tpipe.register_from_buffers(*reg_args, **REG_KW)
            probe = tpipe.boot_probe(*boot)
        torch.cuda.current_stream(cuda).wait_stream(stream)
        want = ttv._initialize_two_view_eager(seed, Kt, a1, a2, v, thresh_px=2.0, weights=rows)
        assert _same(got, want), (P, seed, given)
        assert len({t.untyped_storage().data_ptr() for t in got}) == 1
        assert _same(reg, want_reg) and torch.equal(probe, want_boot)
        good = got.inliers.cpu().numpy()
        assert not good[150:].any() and (good[:150] & gt_in).sum() >= 0.9 * gt_in.sum()
    assert ttv.TWOVIEW_GRAPHS.captures == before + 3 and len(ttv.TWOVIEW_GRAPHS) == 3
    host = graphs.to_host(got)
    assert all(h.device.type == "cpu" and torch.equal(h, w.cpu()) for h, w in zip(host, want))


def test_two_view_replay_makes_no_host_sync(cuda):
    """A replay of the two-view init (K on the card; the padded points,
    the mask and the host noise copied in from the host) synchronises no
    host: the sync debug mode set to raise lets it through; the count
    comes home after it in one copy."""
    K, uv1, uv2, _, _, _ = essential_scene()
    Kt = torch.from_numpy(K).to(cuda)
    a1, a2, v = _padded(uv1, uv2, 256)

    def call(seed):
        return ttv.initialize_two_view(seed, Kt, a1, a2, v, thresh_px=2.0)

    call(0)
    torch.cuda.synchronize()
    before = ttv.TWOVIEW_GRAPHS.captures
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [call(s) for s in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ttv.TWOVIEW_GRAPHS.captures == before
    assert all(int(graphs.to_host(o)[4]) >= 90 for o in outs)


@pytest.mark.parametrize("fused", [True, False])
def test_incremental_sfm_two_view_replayed_equals_eager(cuda, fused, monkeypatch):
    """A 7-frame IncrementalSfM run on the card, every program replayed
    (the two-view inits among them, at their buckets), equals the run with
    every eager function patched in, bit for bit; a second replayed run
    captures nothing."""
    K, seq, _, _ = render_sequence(n_frames=7, n_points=70, seed=0, arc_deg=25.0)
    kw = dict(cfg=SMALL, ba_every=6, fused=fused, device=cuda)
    got = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert ttv.TWOVIEW_GRAPHS.captures >= 1
    counts = [c.captures for c in CACHES]
    again = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert [c.captures for c in CACHES] == counts
    with monkeypatch.context() as m:
        _eager_sfm(m)
        m.setattr(tpipe, "initialize_two_view", ttv._initialize_two_view_eager)
        m.setattr(tpipe, "boot_probe", tpipe._boot_probe_eager)
        m.setattr(tpipe, "loop_probe", tpipe._loop_probe_eager)
        want = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert ttv.TWOVIEW_GRAPHS.captures == counts[0]
    assert len(got.frames_registered) >= 6
    for res in (got, again):
        for f in ("Rs", "ts", "points"):
            a, b = getattr(res, f), getattr(want, f)
            assert a.shape == b.shape and np.array_equal(a, b), f

"""The JAX package's last top-level jits and their CUDA-graph forms on the
CPU: ``MatchPlan``'s power-of-two buckets against the JAX ``MatchPlan``,
the SfM host loop's padded pair matcher against ``_match_pairs_packed``,
the padded bundle adjustment against the JAX ``IncrementalSfM._run_ba``
and against the port's unpadded one, each graph body against the eager
call it stands for, and that CPU plans, frontends and pipelines build no
graph.  The replays themselves run only on a card
(``tests/test_torch_gpu_api_graph.py``)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.models.match_align import MatchPlan as JMatchPlan
from sift_pyocl_tpu.sfm import ba as jba
from sift_pyocl_tpu.sfm import pipeline as jpipe

from sift_pyocl_tpu_torch import LinearAlign, MatchPlan, SiftConfig, SiftPlan
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.models import vo as tvo
from sift_pyocl_tpu_torch.ops import match as tmatch
from sift_pyocl_tpu_torch.ops import transform as ttransform
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.parallel import TwoStagePipeline, VideoSiftFrontend, make_frames_mesh
from sift_pyocl_tpu_torch.parallel import pipeline_octaves as tpo
from sift_pyocl_tpu_torch.parallel import video as tvideo
from sift_pyocl_tpu_torch.sfm import IncrementalSfM
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import pnp as tpnp
from sift_pyocl_tpu_torch.sfm.synthetic import make_problem, perturb
from sift_pyocl_tpu_torch.utils.render3d import render_sequence
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene, transformed_pair

from _torch_threads import _one_torch_thread  # noqa: F401

CFG = SiftConfig(kp_per_octave_cap=256)
CACHES = (tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS, tpnp.PNP_GRAPHS, tpipe.PAIR_GRAPHS,
          tvo.STEP_GRAPHS, tba.LM_GRAPHS, tmatch.MATCH_GRAPHS, ttransform.WARP_GRAPHS,
          tpo.STAGE0_GRAPHS, tpo.STAGE1_GRAPHS)


@pytest.fixture(scope="module")
def kp_pair():
    """Keypoint records of a 256x256 scene and its (6, -4) px translate
    (the port's CPU plan)."""
    a, b = transformed_pair((256, 256), seed=2, dx=6, dy=-4)
    plan = SiftPlan(a.shape, config=CFG, device="cpu")
    kp1, kp2 = plan.keypoints(a), plan.keypoints(b)
    assert len(kp1) >= 40 and len(kp2) >= 40
    return kp1, kp2


@pytest.mark.parametrize("metric", ["L1", "L2"])
@pytest.mark.parametrize("size", [16, 100, 16384])
def test_match_plan_indices_equal_the_jax_match_plan(kp_pair, metric, size):
    """MatchPlan.match_index, padded as the JAX package pads (``size``
    below n: the power-of-two bucket; above: the bucket capped at
    ``size``), gives the JAX MatchPlan's indices bit for bit, plain, with
    an ROI and with an xy radius."""
    kp1, kp2 = kp_pair
    roi = np.zeros((256, 256), np.uint8)
    roi[30:220, 20:200] = 1
    for kw in ({}, {"match_xradius": 8.0, "match_yradius": 5.0}):
        got = MatchPlan(size=size, metric=metric, device="cpu", **kw)
        want = JMatchPlan(size=size, metric=metric, **kw)
        caps = [got._padded(k, np.ones(len(k), bool))[0].shape[0] for k in (kp1, kp2)]
        assert caps == [want._padded(k, np.ones(len(k), bool))[0].shape[0] for k in (kp1, kp2)]
        n_plain = None
        for use_roi in (False, True):
            for p in (got, want):
                p.set_roi(roi) if use_roi else p.unset_roi()
            idx = got.match_index(kp1, kp2)
            np.testing.assert_array_equal(idx, want.match_index(kp1, kp2))
            assert len(idx) >= 10 and idx.dtype == np.int32
            n_plain = n_plain or len(idx)
        assert len(idx) < n_plain


@pytest.mark.parametrize("n1,n2", [(40, 30), (300, 40), (40, 600)])
def test_host_loop_match_equals_the_jax_packed_matcher(kp_pair, n1, n2):
    """The host loop's ``_match`` (both sets padded to their ``_pow2_pad``
    buckets, one packed (cap, 3) int32 result) equals the JAX package's
    ``_match`` and its ``_match_pairs_packed`` output, row for row."""
    kp1, kp2 = kp_pair
    rng = np.random.default_rng(n1 + n2)
    d1 = np.concatenate([kp1["desc"], rng.integers(0, 256, (max(0, n1 - len(kp1)), 128),
                                                   dtype=np.uint8)])[:n1]
    d2 = np.concatenate([kp2["desc"], rng.integers(0, 256, (max(0, n2 - len(kp2)), 128),
                                                   dtype=np.uint8)])[:n2]
    p1, p2 = tpipe._pow2_pad(n1), tpipe._pow2_pad(n2)
    args = (tpipe._pad_rows(d1, p1, np.uint8), np.arange(p1) < n1,
            tpipe._pad_rows(d2, p2, np.uint8), np.arange(p2) < n2)
    want = np.asarray(jpipe._match_pairs_packed(*(jnp.asarray(a) for a in args), ratio_sq=0.7))
    got = tmatch.match_packed(*args, "cpu", ratio_sq=0.7, cache=tpipe.PAIR_GRAPHS)
    assert got.dtype == torch.int32 and got.shape == (p1, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    sfm = IncrementalSfM(np.eye(3, dtype=np.float32), (128, 128), cfg=CFG, device="cpu")
    m = sfm._match(d1, d2)
    np.testing.assert_array_equal(m, jpipe.IncrementalSfM._match(SimpleNamespace(ratio_sq=0.7),
                                                                 d1, d2))
    assert len(m) >= 10


def _sfm_ba(n_cams, n_points, seed):
    """A periodic BA's problem: a synthetic arc (make_problem) started near
    its optimum, as IncrementalSfM._run_ba's host lists, off the buckets."""
    K, gt, obs, _ = make_problem(n_cams=n_cams, n_points=n_points, noise_px=0.4, seed=seed)
    start = perturb(gt, rot_deg=0.5, trans=0.03, point_sigma=0.02, seed=seed + 1,
                    keep_fixed=(0,))
    return np.asarray(K, np.float32), (
        [np.asarray(r, np.float32) for r in start.Rs],
        [np.asarray(t, np.float32) for t in start.ts], np.asarray(start.X, np.float32),
        list(np.asarray(obs.cam)), list(np.asarray(obs.pt)), np.asarray(obs.uv, np.float32))


def _f64_run(args, K, iters):
    """The same LM iterations on the exact lists in float64 (the port's
    lm_iteration): the reference both packages' f32 runs are held to."""
    Rs, ts, X, cam, pt, uv = args
    p = tba.BAParams(*(torch.from_numpy(np.asarray(a, np.float64))
                       for a in (np.stack(Rs), np.stack(ts), X)))
    obs = tba.BAObs(torch.from_numpy(uv).double(), torch.tensor(cam, dtype=torch.int32),
                    torch.tensor(pt, dtype=torch.int32), torch.ones(len(cam), dtype=torch.float64))
    free = torch.ones(len(Rs), dtype=torch.float64)
    free[0] = 0.0
    lam = torch.tensor(1e-3, dtype=torch.float64)
    for _ in range(iters):
        p, lam, _, _ = tba.lm_iteration(p, obs, torch.from_numpy(K).double(), lam, free,
                                        huber_px=3.0, cg_iters=30)
    return [x.numpy() for x in p]


@pytest.mark.parametrize("iters", [1, 3])
def test_padded_run_ba_matches_the_jax_run_ba(iters):
    """IncrementalSfM._run_ba, its observations padded to _pow2_pad(M)
    rows (uv 0, cam 0, pt 0, w 0) and its points to _pow2_pad(P) (X 0),
    against the JAX package's on the same lists.  The padded problem's
    first cost is within rtol 1e-6 of JAX's, and the unobserved padded
    points take a zero step in both.  A scatter-form step with 30 CG
    iterations is ill-conditioned in f32 (the similarity gauge's scale is
    free): each package's Rs, ts and X lie up to 2e-2 from the same
    iterations in float64 and up to 4e-4 from each other (measured), so
    they are held as tests/test_torch_geometry_ba.py holds the scatter
    step: within 1e-3 of JAX's, and no farther from the float64 run than
    JAX's plus 1e-3, entry by entry."""
    K, args = _sfm_ba(8, 150, seed=3)
    M, P = len(args[3]), len(args[2])
    assert tpipe._pow2_pad(M) > M and tpipe._pow2_pad(P) > P
    sfm = IncrementalSfM(K, (240, 320), cfg=CFG, device="cpu")
    got = sfm._run_ba(*args, iters=iters)
    want = jpipe.IncrementalSfM._run_ba(SimpleNamespace(K=K, reproj_px=3.0), *args, iters=iters)
    for g, w, f in zip(got, want, _f64_run(args, K, iters)):
        g, w = np.stack(g), np.stack(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        assert (np.abs(g - f) <= np.abs(w - f) + 1e-3).all()
    assert got[2].shape == (P, 3)

    Mp, Pp = tpipe._pow2_pad(M), tpipe._pow2_pad(P)
    Rs, ts, X, cam, pt, uv = args
    params = (np.stack(Rs), np.stack(ts), tpipe._pad_rows(X, Pp, np.float32))
    obs = (tpipe._pad_rows(uv, Mp, np.float32), tpipe._pad_rows(cam, Mp, np.int32),
           tpipe._pad_rows(pt, Mp, np.int32), tpipe._pad_rows(np.ones(M), Mp, np.float32))
    tp, tcosts = tba.run_ba(tba.BAParams(*params), tba.BAObs(*obs), K, iters=iters,
                            huber_px=3.0, device="cpu")
    jp, jcosts = jba.run_ba(jba.BAParams(*map(jnp.asarray, params)),
                            jba.BAObs(*map(jnp.asarray, obs)), jnp.asarray(K), iters=iters,
                            huber_px=3.0)
    np.testing.assert_allclose(tcosts[0], jcosts[0], rtol=1e-6)
    assert not tp.X[P:].any() and not np.asarray(jp.X)[P:].any()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3)


def test_padded_run_ba_agrees_with_unpadded():
    """The port's padded _run_ba (12 and 25 iterations) against run_ba on
    the exact observations and points: the same Rs, ts and X within rtol
    5e-4 / atol 5e-5 (the padded sums add +0.0 terms to camera 0's and
    point 0's segments; the damped blocks of the unobserved points take a
    zero step; on the CPU they came out bit-equal)."""
    K, args = _sfm_ba(8, 150, seed=5)
    Rs, ts, X, cam, pt, uv = args
    sfm = IncrementalSfM(K, (240, 320), cfg=CFG, device="cpu")
    for iters in (12, 25):
        got = sfm._run_ba(*args, iters=iters)
        want, _ = tba.run_ba(tba.BAParams(np.stack(Rs), np.stack(ts), X),
                             tba.BAObs(uv, np.asarray(cam, np.int32), np.asarray(pt, np.int32),
                                       np.ones(len(cam), np.float32)),
                             K, iters=iters, huber_px=3.0, cg_iters=30, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.stack(g), w.numpy(), rtol=5e-4, atol=5e-5)


def test_graph_bodies_equal_their_eager_calls(kp_pair):
    """Each new graph body on the CPU equals the eager call it stands for:
    the LM iteration (lm_iteration), the packed matcher
    (match_descriptors_jax), the warp (affine_warp on the CPU), both
    pipeline stages (build_scale_space, describe_octaves) and the video
    share (batched_sift)."""
    K, args = _sfm_ba(6, 100, seed=7)
    _, params, obs, Kt, free = tba._ba_inputs(
        tba.BAParams(np.stack(args[0]), np.stack(args[1]), args[2]),
        tba.BAObs(args[5], np.asarray(args[3], np.int32), np.asarray(args[4], np.int32),
                  np.ones(len(args[3]), np.float32)), K, (0,), torch.device("cpu"))
    lam = torch.tensor(1e-3)
    static = (3.0, 30, params.X.shape[0], False, False, False)
    flat = tba._lm_flat(static, *params, lam, *obs, Kt, free)
    want = tba.lm_iteration(params, obs, Kt, lam, free, huber_px=3.0)
    for g, w in zip(flat, (*want[0], *want[1:])):
        assert torch.equal(g, w)

    kp1, kp2 = kp_pair
    d1, d2 = torch.from_numpy(kp1["desc"]), torch.from_numpy(kp2["desc"])
    v1, v2 = torch.ones(len(d1), dtype=torch.bool), torch.ones(len(d2), dtype=torch.bool)
    xy1 = torch.from_numpy(np.stack([kp1["x"], kp1["y"]], 1))
    xy2 = torch.from_numpy(np.stack([kp2["x"], kp2["y"]], 1))
    for metric in ("L1", "L2"):
        for radius in (None, (8.0, 5.0)):
            res = tmatch.match_descriptors_jax(d1, v1, d2, v2, metric=metric, ratio_sq=0.6,
                                               xy1=xy1, xy2=xy2, xy_radius=radius)
            (packed,) = tmatch._match_packed((metric, 0.6, radius), d1, v1, d2, v2,
                                             *(() if radius is None else (xy1, xy2)))
            assert torch.equal(packed, torch.stack([res.idx1, res.idx2,
                                                    res.valid.to(torch.int32)], 1))

    img = synthetic_scene((96, 128), n_blobs=20, seed=4)
    m = np.array([[0.99, 0.05], [-0.04, 1.01]])
    off = np.array([3.5, -2.25])
    (w,) = ttransform._warp_flat(0.0, torch.from_numpy(img), torch.from_numpy(m).float(),
                                 torch.from_numpy(off).float())
    assert torch.equal(w, ttransform.affine_warp(img, m, off, device="cpu"))

    x = torch.from_numpy(synthetic_scene((96, 96), n_blobs=20, seed=5))
    octs = tpo._stage0_flat(CFG, x)
    want_octs = build_scale_space(x, CFG)
    assert len(octs) == 2 * len(want_octs)
    for g, w in zip(octs, (t for lad in want_octs for t in lad)):
        assert torch.equal(g, w)
    buf = tpo.stage1(list(octs), (96, 96), CFG)
    want_buf = tsift.detect_and_describe(x, CFG)
    for g, w in zip(buf, want_buf):
        assert torch.equal(g, w)
    share = tvideo._device_share(x[None].repeat(2, 1, 1), CFG)
    for g, w in zip(share, tvideo.batched_sift(x[None].repeat(2, 1, 1), CFG)):
        assert torch.equal(g, w)


def test_cpu_api_frontends_and_sfm_build_no_graph(kp_pair):
    """A CPU MatchPlan (L1, L2), LinearAlign (align, warp), IncrementalSfM
    (fused and the host loop, BA included), VideoSiftFrontend and
    TwoStagePipeline run their eager bodies: no graph cache captures or
    holds anything."""
    before = [c.captures for c in CACHES]
    kp1, kp2 = kp_pair
    for metric in ("L1", "L2"):
        assert len(MatchPlan(metric=metric, device="cpu").match_index(kp1, kp2)) >= 10
    ref, img = transformed_pair((128, 128), seed=2, dx=6, dy=-4)
    out = LinearAlign(ref, config=CFG, device="cpu").align(img, return_all=True)
    np.testing.assert_allclose(out["offset"], [4.0, -6.0], atol=0.5)
    K, seq, _, _ = render_sequence(n_frames=5, n_points=70, seed=0, arc_deg=20.0)
    for fused in (True, False):
        res = IncrementalSfM(K, seq[0].shape, cfg=CFG, ba_every=4, fused=fused,
                             device="cpu").run(seq)
        assert res is not None and len(res.frames_registered) >= 4
    frames = np.stack([synthetic_scene((96, 96), n_blobs=20, seed=s) for s in range(2)])
    fe = VideoSiftFrontend((96, 96), batch=2, cfg=CFG,
                           mesh=make_frames_mesh(devices=[torch.device("cpu")] * 2))
    assert fe(frames).x.shape[0] == 2
    assert len(list(TwoStagePipeline((96, 96), CFG, devices=["cpu"]).process(frames))) == 2
    assert [c.captures for c in CACHES] == before
    assert all(len(c) == 0 for c in CACHES)

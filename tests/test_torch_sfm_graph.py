"""The SfM path's CUDA-graph forms on the CPU: the split PnP draws, the
JAX package's power-of-two map buckets, padded registration and padded
RANSAC-PnP against the JAX package's padded programs (given JAX's draws)
and against the port's unpadded ones, and that a CPU ``SiftPlan`` and a
CPU ``IncrementalSfM`` build no graph.  The replays themselves run only
on a card (``tests/test_torch_gpu_sfm_graph.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.sfm import pipeline as jpipe
from sift_pyocl_tpu.sfm.pnp import ransac_pnp as j_ransac_pnp

from sift_pyocl_tpu_torch import SiftPlan
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.models import vo as tvo
from sift_pyocl_tpu_torch.sfm import IncrementalSfM
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import pnp as tpnp
from sift_pyocl_tpu_torch.utils import graphs
from sift_pyocl_tpu_torch.utils.convert import keypoint_buffer_from_jax
from sift_pyocl_tpu_torch.utils.render3d import render_sequence

from test_torch_sfm_geometry import _pnp_outlier_scene, jax_pnp_draws
from test_torch_sfm_pipeline import CFG, JCFG, _uv, seq3  # noqa: F401
from _torch_threads import _one_torch_thread  # noqa: F401

CACHES = (tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS, tpnp.PNP_GRAPHS, tvo.STEP_GRAPHS)


@pytest.mark.parametrize("seed,n,zeros", [(0, 100, 9), (5, 256, 3), (7, 20, 2), (11, 9, 0)])
def test_split_draws_give_pnp_draws_bits(seed, n, zeros):
    """The host part (xi, Gumbel noise from the seed) and the device part
    (the masked top-k subsets) give ``pnp_draws``'s bits, with fewer rows
    of w > 0 than a subset holds too."""
    w = torch.ones(n)
    if zeros:
        w[::zeros] = 0.0
    xi, sub = tpnp.pnp_draws(seed, w)
    hxi, g = tpnp.pnp_host_draws(seed, 16, n)
    assert hxi.device.type == g.device.type == "cpu" and g.shape == (16, n)
    assert torch.equal(hxi, xi) and torch.equal(tpnp.pnp_subsets(g, w), sub)
    assert torch.equal(sub.sum(1), torch.full((16,), float(min(12, n))))


@pytest.mark.parametrize("floor", [256, 64])
def test_pow2_pad_equals_the_jax_package(floor):
    for n in (0, 1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 672, 1000, 4097):
        assert tpipe._pow2_pad(n, floor) == jpipe._pow2_pad(n, floor), n
    assert [tpipe._pow2_pad(n) for n in (1, 256, 257, 672)] == [256, 256, 512, 1024]


def test_to_host_views_one_storage_as_its_tensors():
    """``to_host``'s re-viewing of one copied storage (what it does with a
    replay's outputs on a card): each tensor of a packed buffer, at its
    offset, shape and strides, with the same bits; host tensors as they
    are."""
    rng = np.random.default_rng(3)
    ts = [torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32)),
          torch.tensor(7, dtype=torch.int32), torch.from_numpy(rng.random(5) < 0.5),
          torch.from_numpy(rng.integers(0, 256, (7, 128), dtype=np.uint8))]
    lay = graphs._Layout([(tuple(t.shape), t.dtype) for t in ts])
    views = lay.views(torch.cat(lay.parts(ts, torch.zeros(graphs.ALIGN, dtype=torch.uint8))))
    views.append(views[0].T)
    host = views[0].untyped_storage()
    for g, w in zip([torch.empty(0, dtype=t.dtype).set_(host, t.storage_offset(), t.shape,
                                                        t.stride()) for t in views],
                    ts + [ts[0].T]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(graphs.to_host(views), ts):
        assert torch.equal(g, w)


def _padded_args(jbufs, K, gtR, gtT, P=None):
    """tests/test_torch_sfm_pipeline.py's registration inputs (frame 1
    against a map of frames 0 and 2 triangulated at the true poses) with
    the map padded to P rows (its bucket where None), as ``fused_call``
    pads it (P = 0: the exact map); and the map's true rows."""
    from sift_pyocl_tpu.ops.match import match_descriptors_jax as j_match
    from sift_pyocl_tpu.sfm import geometry as jg

    d0, d2 = jbufs[0], jbufs[2]
    m = j_match(d0.desc, d0.valid, d2.desc, d2.valid, ratio_sq=0.7)
    ok = np.asarray(m.valid)
    i0, i2 = np.asarray(m.idx1)[ok], np.asarray(m.idx2)[ok]
    X = np.asarray(jg.triangulate_two_view(
        jnp.asarray(K), jnp.asarray(gtR[0]), jnp.asarray(gtT[0]), jnp.asarray(K),
        jnp.asarray(gtR[2]), jnp.asarray(gtT[2]), jnp.asarray(_uv(d0)[i0]),
        jnp.asarray(_uv(d2)[i2]))[0])
    n = len(X)
    P = tpipe._pow2_pad(n) if P is None else (P or n)
    md = tpipe._pad_rows(np.asarray(d0.desc)[i0], P, np.uint8)
    mv = tpipe._pad_rows(np.ones(n), P, bool)
    mX = tpipe._pad_rows(X, P, np.float32)
    return [md, mv, mX, np.asarray(d0.desc), _uv(d0), np.asarray(d0.valid), gtR[0], gtT[0],
            gtR[0], gtT[0], K], n


KW = dict(new_cap=256, ratio_sq=0.7, reproj_px=3.0, metric="L1")


def test_padded_registration_matches_the_jax_padded_program(seq3, monkeypatch):
    """The map padded to its bucket, through the JAX package's
    ``register_frame_fused`` and the port's ``register_from_buffers`` with
    JAX's draws on the padded rows: counts and every map and new-point row
    exact, R and t within 1e-4, new points within 1e-3 (the tolerances of
    ``test_register_from_buffers_matches_jax``)."""
    K, frames, gtR, gtT, jbufs = seq3
    args, n = _padded_args(jbufs, K, gtR, gtT)
    P = args[0].shape[0]
    assert P == 256 and n >= 20
    key = jax.random.key(11)
    monkeypatch.setattr(jpipe, "detect_and_describe", lambda frame, cfg: jbufs[1])
    fused = jax.jit(functools.partial(jpipe.register_frame_fused.__wrapped__, cfg=JCFG, **KW))
    packed = np.asarray(fused(jnp.asarray(frames[1]), key, *(jnp.asarray(a) for a in args))[0])
    head, rows, new = packed[0], packed[1:1 + P], packed[1 + P:]
    keep = rows[:, 0] > 0
    draws = [torch.from_numpy(np.array(d))
             for d in jax_pnp_draws(key, jnp.asarray(keep, jnp.float32))]
    got = tpipe.register_from_buffers(keypoint_buffer_from_jax(jbufs[1]), 0,
                                      *(torch.from_numpy(np.array(a)) for a in args), **KW,
                                      draws=draws)
    assert int(got.n_match) == int(head[13]) and int(got.n_inl) == int(head[12]) >= 10
    assert not keep[n:].any()
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.inl.numpy(), rows[:, 1] > 0)
    np.testing.assert_array_equal(got.uv.numpy()[keep], rows[keep, 2:4])
    np.testing.assert_array_equal(got.desc.numpy()[keep], packed[1:1 + P, 8:][keep])
    np.testing.assert_allclose(got.R.numpy(), head[:9].reshape(3, 3), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), head[9:12], atol=1e-4)
    new_ok = new[:, 0] > 0
    assert new_ok.sum() >= 5
    np.testing.assert_array_equal(got.new_ok.numpy(), new_ok)
    np.testing.assert_allclose(got.new_X.numpy()[new_ok], new[new_ok, 1:4], atol=1e-3)
    np.testing.assert_array_equal(got.new_uv_prev.numpy()[new_ok], new[new_ok, 4:6])
    np.testing.assert_array_equal(got.new_uv_cur.numpy()[new_ok], new[new_ok, 6:8])
    np.testing.assert_array_equal(got.new_desc.numpy()[new_ok], new[new_ok, 8:])


def test_padded_registration_agrees_with_unpadded(seq3):
    """The port's registration on the exact map and on the map padded to
    256 and 512 rows, the same subsets on the true rows (zero on the
    padding): the same keep, inlier and new-point rows, R and t within
    1e-4 (padded sums run over more terms, in another order)."""
    K, frames, gtR, gtT, jbufs = seq3
    buf = keypoint_buffer_from_jax(jbufs[1])
    exact, n = _padded_args(jbufs, K, gtR, gtT, P=0)
    exact[3:6] = [torch.from_numpy(np.array(a)) for a in exact[3:6]]
    first = tpipe.register_from_buffers(buf, 0, *exact, **KW)
    xi, sub = tpnp.pnp_draws(4, first.keep.to(torch.float32))
    want = tpipe.register_from_buffers(buf, 0, *exact, **KW, draws=(xi, sub))
    assert int(want.n_inl) >= 10 and int(want.new_ok.sum()) >= 5
    for P in (256, 512):
        args, _ = _padded_args(jbufs, K, gtR, gtT, P=P)
        args[3:6] = exact[3:6]
        sub_p = torch.zeros((sub.shape[0], P))
        sub_p[:, :n] = sub
        got = tpipe.register_from_buffers(buf, 0, *args, **KW, draws=(xi, sub_p))
        assert int(got.n_match) == int(want.n_match) and int(got.n_inl) == int(want.n_inl)
        for f in ("keep", "inl", "uv", "desc"):
            assert torch.equal(getattr(got, f)[:n], getattr(want, f)), f
        assert not bool(got.keep[n:].any()) and not bool(got.inl[n:].any())
        assert torch.equal(got.new_ok, want.new_ok)
        ok = want.new_ok
        np.testing.assert_allclose(got.R.numpy(), want.R.numpy(), atol=1e-4)
        np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=1e-4)
        np.testing.assert_allclose(got.new_X.numpy()[ok], want.new_X.numpy()[ok], atol=1e-3)


def test_host_loop_padded_ransac_pnp_matches_jax():
    """The host loop's RANSAC-PnP on rows padded to their bucket (X = 0,
    uv = 0, w = 0, as ``_run_host`` pads them): the JAX package's
    ``ransac_pnp`` and the port's, given JAX's draws on the padded rows,
    give the same inliers and count, R and t within 1e-4; the port's padded
    call against its unpadded one with the same subsets on the true rows:
    the same inliers, R and t within 1e-4."""
    K, R_gt, t_gt, X, uv, R0, t0, gt_in = _pnp_outlier_scene()
    n = len(X)
    P = tpipe._pow2_pad(n)
    Xp, uvp, wp = (tpipe._pad_rows(a, P, np.float32) for a in (X, uv, np.ones(n)))
    key = jax.random.key(3)
    want = j_ransac_pnp(key, jnp.asarray(K), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(Xp),
                        jnp.asarray(uvp), jnp.asarray(wp))
    draws = [torch.from_numpy(np.array(d)) for d in jax_pnp_draws(key, jnp.asarray(wp))]
    got = tpnp.ransac_pnp(0, torch.from_numpy(K), R0, t0, Xp, uvp, wp, draws=draws)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) and not bool(got[2][n:].any())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert (got[2].numpy()[:n] & gt_in).sum() >= 0.9 * gt_in.sum()

    xi, sub = tpnp.pnp_draws(6, torch.ones(n))
    sub_p = torch.zeros((16, P))
    sub_p[:, :n] = sub
    Kt = torch.from_numpy(K)
    exact = tpnp.ransac_pnp(0, Kt, R0, t0, X, uv, np.ones(n, np.float32), draws=(xi, sub))
    padded = tpnp.ransac_pnp(0, Kt, R0, t0, Xp, uvp, wp, draws=(xi, sub_p))
    assert torch.equal(padded[2][:n], exact[2]) and int(padded[3]) == int(exact[3])
    np.testing.assert_allclose(padded[0].numpy(), exact[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(padded[1].numpy(), exact[1].numpy(), atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_siftplan_and_incremental_sfm_build_no_graph(fused):
    """A CPU plan runs the eager detector (its keypoints those of the eager
    buffer) and a CPU IncrementalSfM run, either architecture, registers
    its frames: no graph cache captures or holds anything."""
    before = [c.captures for c in CACHES]
    K, seq, _, _ = render_sequence(n_frames=5, n_points=70, seed=0, arc_deg=20.0)
    plan = SiftPlan(seq[0].shape, config=CFG, device="cpu")
    img = np.asarray(seq[0], np.float32)
    np.testing.assert_array_equal(
        plan.keypoints(img), tsift.to_keypoint_records(tsift._detector(CFG)(torch.from_numpy(img))))
    res = IncrementalSfM(K, seq[0].shape, cfg=CFG, ba_every=6, fused=fused,
                         device="cpu").run(seq)
    assert res is not None and len(res.frames_registered) >= 4
    assert [c.captures for c in CACHES] == before
    assert all(len(c) == 0 for c in CACHES)

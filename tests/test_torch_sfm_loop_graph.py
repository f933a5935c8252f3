"""Config 4's last SfM programs in the graph form the card replays, on the
CPU: the pose graph's Gauss-Newton step (``sfm/posegraph.py::
_pose_graph_flat``), the fused path's loop-closure probe on the old map
padded to the JAX package's bucket (``sfm/pipeline.py::loop_probe``) and
the host loop's frame-by-frame loop closure (``_loop_edges_host``), each
against the eager loop or the JAX package's program.

Drift between the two packages, and how each test holds it:
* PnP draws: the port is fed the draws JAX's ``ransac_pnp`` takes from its
  key (the fused probe: one key a candidate, split from one; the host
  loop: its key stream, one split a call).
* Padding: the padded probe sums over zero rows, so padded against
  unpadded is a tolerance comparison on the real rows.

On a CUDA card the same functions replay CUDA graphs; those replays are
held to these eager forms in tests/test_torch_gpu_sfm_loop_graph.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_pyocl_tpu.config as jcfg
from sift_pyocl_tpu.models.sift import detect_and_describe as j_detect
from sift_pyocl_tpu.ops.match import match_descriptors_dense as j_dense
from sift_pyocl_tpu.ops.match import match_descriptors_jax as j_match
from sift_pyocl_tpu.sfm import geometry as jg
from sift_pyocl_tpu.sfm import pipeline as jpipe

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import posegraph as tpg
from sift_pyocl_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
from sift_pyocl_tpu_torch.sfm.pipeline import IncrementalSfM
from sift_pyocl_tpu_torch.utils.convert import keypoint_buffer_from_jax
from sift_pyocl_tpu_torch.utils.render3d import render_sequence

from test_torch_sfm_geometry import chain_graph, jax_pnp_draws  # noqa: F401
from _torch_threads import _one_torch_thread  # noqa: F401

CFG = SiftConfig(kp_per_octave_cap=256)
JCFG = jcfg.SiftConfig(kp_per_octave_cap=256)
CAND = [2, 3, 4]            # the candidate frames (cameras 2-4)
NEW_CACHES = (tpg.POSEGRAPH_GRAPHS, tpipe.BOOT_PROBE_GRAPHS, tpipe.LOOP_PROBE_GRAPHS)


def _uv(buf):
    return np.stack([np.asarray(buf.x), np.asarray(buf.y)], -1)


def _host_kps(buf):
    m = np.asarray(buf.valid)
    return {"x": np.asarray(buf.x)[m], "y": np.asarray(buf.y)[m], "desc": np.asarray(buf.desc)[m]}


@pytest.fixture(scope="module")
def seq5():
    """Five frames 4 deg apart, the JAX package's keypoint buffers, and a
    loop-closure map: the old points (first seen by cameras 0 and 1) are
    the ratio matches of frames 0 and 1 triangulated at the true poses,
    with frame 0's descriptors; every frame is its own camera, at its true
    pose."""
    K, frames, gtR, gtT = render_sequence(n_frames=5, n_points=70, image_size=(320, 240),
                                          seed=0, arc_deg=16.0)
    det = jax.jit(lambda f: j_detect(f, JCFG))
    bufs = [det(jnp.asarray(f)) for f in frames]
    d0, d1 = bufs[0], bufs[1]
    m = j_match(d0.desc, d0.valid, d1.desc, d1.valid, ratio_sq=0.7)
    ok = np.asarray(m.valid)
    i0, i1 = np.asarray(m.idx1)[ok], np.asarray(m.idx2)[ok]
    X = np.asarray(jg.triangulate_two_view(
        jnp.asarray(K), jnp.asarray(gtR[0]), jnp.asarray(gtT[0]), jnp.asarray(K),
        jnp.asarray(gtR[1]), jnp.asarray(gtT[1]), jnp.asarray(_uv(d0)[i0]),
        jnp.asarray(_uv(d1)[i1]))[0]).astype(np.float32)
    assert 40 <= len(X) < 64, len(X)
    Rs = [np.asarray(r, np.float32) for r in gtR]
    ts = [np.asarray(t, np.float32) for t in gtT]
    return dict(K=K, frames=frames, gtR=gtR, gtT=gtT, bufs=bufs, old_desc=np.asarray(d0.desc)[i0],
                old_X=X, Rs=Rs, ts=ts)


def _sfm(scene, **kw):
    """A CPU IncrementalSfM holding the JAX package's buffers and host
    keypoints of the scene's frames."""
    sfm = IncrementalSfM(scene["K"], scene["frames"][0].shape, cfg=CFG, device="cpu", **kw)
    sfm._bufs = {f: keypoint_buffer_from_jax(b) for f, b in enumerate(scene["bufs"])}
    sfm._kps_cache = {f: _host_kps(b) for f, b in enumerate(scene["bufs"])}
    return sfm


@pytest.mark.parametrize("edges,huber", [("exact", 0.1), ("noisy", 0.1), ("noisy", 10.0)])
def test_flat_pose_graph_step_looped_equals_the_eager_solve(chain_graph, edges, huber):  # noqa: F811
    """_pose_graph_flat (the graph body: its segment layouts made each
    step) looped 20 times with the carry fed back equals the eager
    optimize_pose_graph (layouts made once) bit for bit on the CPU, and
    the CPU call captures no graph."""
    _, start, graphs_, free = chain_graph
    g = tpg.PoseGraph(**{k: torch.from_numpy(v) for k, v in graphs_[edges].items()})
    Rs, ts = torch.from_numpy(start.Rs), torch.from_numpy(start.ts)
    want = tpg.optimize_pose_graph(Rs, ts, g, torch.from_numpy(free), iters=20, huber=huber)
    carry = (Rs, ts, torch.full((), 1e-4))
    for _ in range(20):
        *carry, cost = tpg._pose_graph_flat((huber,), *carry, g.i, g.j, g.Z_R, g.Z_t, g.w,
                                            torch.from_numpy(free))
    for got, w in zip((*carry[:2], cost), want):
        assert torch.equal(got, w)
    assert len(tpg.POSEGRAPH_GRAPHS) == 0 and tpg.POSEGRAPH_GRAPHS.captures == 0


def _jax_probe(scene, key, Q):
    """The JAX package's _loop_probe_batched over CAND at their true poses
    on the old map padded to Q rows, and the (xi, subset) draws its
    ransac_pnp takes from each candidate's key (over the Q rows)."""
    n = len(scene["old_X"])
    od = np.zeros((Q, 128), np.uint8)
    od[:n] = scene["old_desc"]
    oX = np.zeros((Q, 3), np.float32)
    oX[:n] = scene["old_X"]
    ov = np.arange(Q) < n
    bufs = [scene["bufs"][f] for f in CAND]
    keys = jax.random.split(key, len(CAND))
    out = np.asarray(jpipe._loop_probe_batched(
        keys, jnp.asarray(od), jnp.asarray(ov), jnp.asarray(oX), jnp.stack([b.desc for b in bufs]),
        jnp.stack([b.valid for b in bufs]), jnp.stack([jnp.asarray(_uv(b)) for b in bufs]),
        jnp.asarray(np.stack([scene["Rs"][f] for f in CAND])),
        jnp.asarray(np.stack([scene["ts"][f] for f in CAND])), jnp.asarray(scene["K"]),
        ratio_sq=0.7, metric="L1", thresh_px=3.0))
    draws = [jax_pnp_draws(k, j_dense(jnp.asarray(od), jnp.asarray(ov), b.desc, b.valid,
                                      metric="L1", ratio_sq=0.7)[0].astype(jnp.float32))
             for k, b in zip(keys, bufs)]
    return out, [np.stack([d[i] for d in draws]) for i in (0, 1)]


def test_padded_loop_probe_matches_jax_given_its_draws(seq5):
    """IncrementalSfM._loop_probe pads the old map to _pow2_pad(n,
    floor=64) rows as the JAX package does; fed the draws JAX's probe takes
    there, its rows equal _loop_probe_batched's on the same padded inputs:
    match and inlier counts equal, R and t within 1e-4."""
    n = len(seq5["old_X"])
    Q = jpipe._pow2_pad(n, floor=64)
    assert Q == tpipe._pow2_pad(n, floor=64) == 64
    want, draws = _jax_probe(seq5, jax.random.key(3), Q)
    sfm = _sfm(seq5)
    got = sfm._loop_probe(CAND, CAND, seq5["old_desc"], seq5["old_X"], seq5["Rs"], seq5["ts"],
                          draws=draws)
    assert got.shape == (len(CAND), 14)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    assert (want[:, 1] >= 15).all(), want[:, :2]
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], atol=1e-4)
    assert all(len(c) == 0 and c.captures == 0 for c in NEW_CACHES)


def test_padded_loop_probe_agrees_with_unpadded_on_the_real_rows(seq5):
    """loop_probe on the old map padded to 64 rows against the same call
    on its n real rows, given the same draws on the real rows: match and
    inlier counts equal, R and t within 1e-5 (the padded sums add zero
    rows, in another order)."""
    n = len(seq5["old_X"])
    _, (xi, sub) = _jax_probe(seq5, jax.random.key(4), 64)
    assert not sub[:, :, n:].any()
    bufs = [keypoint_buffer_from_jax(seq5["bufs"][f]) for f in CAND]
    slots = (torch.stack([b.desc for b in bufs]), torch.stack([b.valid for b in bufs]),
             torch.stack([torch.stack([b.x, b.y], -1) for b in bufs]),
             np.stack([seq5["Rs"][f] for f in CAND]), np.stack([seq5["ts"][f] for f in CAND]))
    K = torch.from_numpy(seq5["K"])
    padded = tpipe.loop_probe(*slots, tpipe._pad_rows(seq5["old_desc"], 64, np.uint8),
                              np.arange(64) < n, tpipe._pad_rows(seq5["old_X"], 64, np.float32),
                              K, draws=(xi, sub)).numpy()
    real = tpipe.loop_probe(*slots, seq5["old_desc"], np.ones(n, bool), seq5["old_X"], K,
                            draws=(xi, sub[:, :, :n])).numpy()
    np.testing.assert_array_equal(padded[:, :2], real[:, :2])
    np.testing.assert_allclose(padded[:, 2:], real[:, 2:], atol=1e-5)
    # the eager form is the same function
    eager = tpipe._loop_probe_eager(*slots, seq5["old_desc"], np.ones(n, bool), seq5["old_X"], K,
                                    draws=(xi, sub[:, :, :n])).numpy()
    np.testing.assert_array_equal(eager, real)


def test_host_loop_closure_takes_the_jax_host_route(seq5, monkeypatch):
    """IncrementalSfM(fused=False)._pose_graph_close probes the candidates
    frame by frame, as the JAX package's host loop: one _match of the old
    map's descriptors against the frame's compacted keypoints a candidate,
    and one ransac_pnp on the matched rows padded to _pow2_pad(len(mm)) a
    candidate with at least loop_min_inliers matches.  Fed the draws of
    the JAX host loop's key stream, its loop edges are the JAX package's on
    the same map (loop_min_inliers 20, so that a frame is turned away): the
    same accepted cameras and Z within 1e-4.  (The solve from the drifted
    start moves a translation of ~9 by up to 1e-2 for those 1e-4 in Z;
    given the same edges the two packages' solves agree within 1e-4,
    test_torch_sfm_geometry.py::test_optimize_pose_graph_matches_jax.)"""
    n = len(seq5["old_X"])
    frames_reg = [0, 1, *CAND]
    cams = {f: f for f in frames_reg}
    pt_first = np.zeros(n, np.int32)
    # drift the later cameras, as odometry does, so that the pose graph moves them
    Rs, ts = list(seq5["Rs"]), [t + np.float32(0.02) * c for c, t in enumerate(seq5["ts"])]
    kps = [_host_kps(b) for b in seq5["bufs"]]
    js = jpipe.IncrementalSfM(seq5["K"], seq5["frames"][0].shape, cfg=JCFG, fused=False,
                              loop_min_inliers=20, seed=6)
    want = js._pose_graph_close(kps, frames_reg, cams, list(Rs), list(ts), seq5["old_X"],
                                seq5["old_desc"], pt_first)
    sfm = _sfm(seq5, fused=False, loop_min_inliers=20)
    matched, pnp_rows, key = [], [], [jax.random.key(6)]
    match, ransac_pnp = sfm._match, tpipe.ransac_pnp

    def counted_match(d1, d2):
        mm = match(d1, d2)
        matched.append((len(d1), len(d2), len(mm)))
        return mm

    def jax_drawn_pnp(seed, K, R0, t0, X, uv, w, **kw):
        key[0], k = jax.random.split(key[0])
        pnp_rows.append(len(X))
        return ransac_pnp(seed, K, R0, t0, X, uv, w,
                          draws=[torch.from_numpy(np.array(d)) for d in jax_pnp_draws(k, jnp.asarray(w))],
                          **kw)

    monkeypatch.setattr(sfm, "_match", counted_match)
    monkeypatch.setattr(tpipe, "ransac_pnp", jax_drawn_pnp)
    got = sfm._pose_graph_close(frames_reg, cams, list(Rs), list(ts), seq5["old_X"],
                                seq5["old_desc"], pt_first)
    assert [m[:2] for m in matched] == [(n, len(kps[f]["x"])) for f in CAND]
    assert pnp_rows == [tpipe._pow2_pad(m[2]) for m in matched if m[2] >= 20]
    assert 1 <= sfm.n_loop_edges == js.n_loop_edges < len(CAND)
    ZR, Zt, ej = sfm._pgo_debug[4]
    jZR, jZt, jej = js._pgo_debug[4]
    assert ej == jej
    np.testing.assert_allclose(ZR, jZR, atol=1e-4)
    np.testing.assert_allclose(Zt, jZt, atol=1e-4)
    assert len(got[0]) == len(want[0]) == len(frames_reg) and np.isfinite(np.stack(got[1])).all()
    assert all(len(c) == 0 for c in NEW_CACHES)


def test_cpu_run_probes_at_the_jax_buckets_and_captures_nothing(seq5, monkeypatch):
    """The fused IncrementalSfM over the five frames on the CPU: the
    bootstrap probes one chunk of 4 candidates (stacked), the loop probe
    gets the old map padded to its 64-row bucket, the pose graph runs, and
    none of the new graph caches holds or captured a graph; poses near the
    truth."""
    probes, loops = [], []
    boot_probe, loop_probe = tpipe.boot_probe, tpipe.loop_probe

    def seen_boot(*args, **kw):
        probes.append(tuple(args[3].shape))
        return boot_probe(*args, **kw)

    def seen_loop(*args, **kw):
        loops.append((tuple(args[0].shape), tuple(np.shape(args[5]))))
        return loop_probe(*args, **kw)

    monkeypatch.setattr(tpipe, "boot_probe", seen_boot)
    monkeypatch.setattr(tpipe, "loop_probe", seen_loop)
    sfm = IncrementalSfM(seq5["K"], seq5["frames"][0].shape, cfg=CFG, min_matches=20,
                         device="cpu")
    res = sfm.run(seq5["frames"])
    assert res is not None and len(res.frames_registered) == 5
    cap = probes[0][1]
    assert probes[0] == (4, cap, 128)
    assert len(loops) == 1 and loops[0][0][0] == 3 and loops[0][1][0] % 64 == 0
    assert sfm.n_loop_edges >= 1
    assert all(len(c) == 0 and c.captures == 0 for c in NEW_CACHES)
    reg = res.frames_registered
    assert ate_rmse(camera_centers(res.Rs, res.ts),
                    camera_centers(seq5["gtR"][reg], seq5["gtT"][reg])) < 0.1

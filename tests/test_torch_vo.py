"""The VO step: the port's ``vo_init`` / ``vo_step`` against the JAX
package's on the scene of ``tests/test_vo.py::test_vo_step_quick`` (96^2
renders of a 3-D blob cloud, window 3, 32 points a frame).

The JAX runs use the keypoint kernels in interpret mode
(``kp_backend="pallas"``), whose slot layout the port shares.  The port runs
on the CPU, where every kernel wrapper takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.models import sift as jsift
from sift_pyocl_tpu.models import vo as jvo
from sift_pyocl_tpu.sfm import ba as jba
from sift_pyocl_tpu.utils.testimage import blob_cloud, render_point_cloud

from sift_pyocl_tpu_torch import SiftConfig, VOConfig, VOState, vo_init, vo_step
from sift_pyocl_tpu_torch.models import vo as tvo
from sift_pyocl_tpu_torch.models.vo import _vo_update
from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm.ba import lm_iteration
from sift_pyocl_tpu_torch.utils.convert import (keypoint_buffer_from_jax, vo_config_from_jax,
                                                vo_state_from_jax)
from sift_pyocl_tpu_torch.utils.profiling import vo_frames
from _torch_threads import _one_torch_thread  # noqa: F401

H = W = 96
K = np.array([[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1.0]], np.float32)
CFG = SiftConfig(kp_per_octave_cap=128, kp_backend="pallas")
JCFG = JaxConfig(**{**dataclasses.asdict(CFG), "pallas_interpret": True})
JVO = jvo.VOConfig(window=3, pts_per_frame=32, obs_per_frame=64, pnp_n=32, pnp_iters=3,
                   cg_iters=3, min_track_matches=8)
VO = vo_config_from_jax(JVO)
N_FRAMES = 3


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """The JAX suite's workaround for XLA's compile segfault after many
    executables in one process (tests/test_vo.py)."""
    jax.clear_caches()
    yield


def _frames():
    pts, radii, amps = blob_cloud(n=70, seed=2, depth=(3.5, 8.0), span=3.5)
    eye = np.eye(3, dtype=np.float32)
    return [render_point_cloud(pts, radii, amps, K, eye,
                               -np.array([0.12 * i, 0.0, 0.0], np.float32), (H, W))
            for i in range(N_FRAMES + 1)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's VO over the frames: its initial state, and per
    frame its frontend buffer, output and state."""
    frames = _frames()
    Kj = jnp.asarray(K)
    st0 = jvo.vo_init(jnp.asarray(frames[0]), Kj, JCFG, JVO)
    st, steps = st0, []
    for f in frames[1:]:
        buf = jsift.detect_and_describe(jnp.asarray(f), JCFG)
        st, out = jvo.vo_step(st, jnp.asarray(f), Kj, JCFG, JVO)
        steps.append((buf, out, st))
    return frames, st0, steps


@pytest.fixture(scope="module")
def port_back_end(jax_run):
    """The port's ``_vo_update`` on each frame's JAX frontend buffer, started
    from the JAX state before that frame, so that each step is compared on
    its own; per frame its state, output and the inputs of its BA iteration."""
    _, st0, steps = jax_run
    Kt = torch.from_numpy(K)
    ba_inputs = []

    def spy(*args, **kw):
        ba_inputs.append((args, kw))
        return lm_iteration(*args, **kw)

    results, prev = [], st0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvo, "lm_iteration", spy)
        for jbuf, _, jst in steps:
            st, out = _vo_update(vo_state_from_jax(prev), keypoint_buffer_from_jax(jbuf), Kt, VO)
            results.append((st, out, ba_inputs[-1]))
            prev = jst
    assert len(ba_inputs) == N_FRAMES * VO.ba_iters
    return results


# The window's BA system is ill-conditioned on this scene (three cameras, two
# of them the fixed gauge, 32 points a frame, points 3.5-8 deep over a 0.12
# baseline): at frame 3 the f32 Schur solves of JAX and the port land on
# either side of the f64 solve of the same system (within F32_GAP, see
# test_vo_ba_f32_solves_bracket_the_f64_solve), and one step ends 5.4e-4
# apart in R, 2.7e-3 in t and 5.7e-3 in X (measured on the CPU, torch 2.13,
# jax 0.9).  Frames 1-2 agree within 4e-5 (R, t) and 1.5e-4 (X).  Every
# other field and every discrete outcome meets the acceptance's 1e-4.
POSE_ATOL = {"R": 1e-3, "t": 4e-3}
X_ATOL = 8e-3
ATOL = 1e-4
F32_GAP = {"cameras": 1.2e-3, "points": 2.5e-3}


def _weighted_state_close(got: VOState, want) -> None:
    """State arrays equal where they carry weight: zero-weight observation
    slots and invalid map slots may hold anything."""
    w = np.asarray(want.obs_w) > 0
    np.testing.assert_array_equal(got.obs_w.numpy() > 0, w)
    np.testing.assert_allclose(got.obs_w.numpy(), np.asarray(want.obs_w), atol=ATOL)
    np.testing.assert_array_equal(got.obs_pt.numpy()[w], np.asarray(want.obs_pt)[w])
    np.testing.assert_allclose(got.obs_uv.numpy()[w], np.asarray(want.obs_uv)[w], atol=ATOL)
    xv = np.asarray(want.Xvalid) > 0
    np.testing.assert_array_equal(got.Xvalid.numpy(), np.asarray(want.Xvalid))
    np.testing.assert_allclose(got.X.numpy()[xv], np.asarray(want.X)[xv], atol=X_ATOL)
    np.testing.assert_array_equal(got.Xdesc.numpy()[xv], np.asarray(want.Xdesc)[xv])
    np.testing.assert_allclose(got.tri_par.numpy(), np.asarray(want.tri_par), atol=ATOL)
    for f, atol in (("Rs", POSE_ATOL["R"]), ("ts", POSE_ATOL["t"]),
                    ("key_R", POSE_ATOL["R"]), ("key_t", POSE_ATOL["t"])):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=atol, err_msg=f)
    for f in ("key_frame", "frame", "prev_valid", "key_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_vo_back_end_matches_jax(jax_run, port_back_end):
    """Each frame's JAX frontend buffer through the port's back end, from the
    JAX state before that frame, reproduces that JAX vo_step: counts and
    decisions exactly, the PnP residual and BA cost to 1e-4, poses and map
    points to the one-step f32 limits above, the rest of the state to 1e-4."""
    _, _, steps = jax_run
    for i, ((_, jout, jst), (st, out, _)) in enumerate(zip(steps, port_back_end)):
        for f in ("n_matches", "tracked", "n_kp", "n_spawn_tri"):
            assert int(getattr(out, f)) == int(getattr(jout, f)), (i, f)
        for f, atol in POSE_ATOL.items():
            np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                       atol=atol, err_msg=f"{f}, frame {i + 1}")
        np.testing.assert_allclose(float(out.rms_px), float(jout.rms_px), rtol=1e-4)
        np.testing.assert_allclose(float(out.ba_cost), float(jout.ba_cost), rtol=1e-4)
        np.testing.assert_allclose(float(st.lam), float(jst.lam), rtol=1e-6)
        _weighted_state_close(st, jst)


def test_vo_ba_f32_solves_bracket_the_f64_solve(port_back_end):
    """The f64 witness of the limits above: on each frame's BA inputs the
    JAX and the port's f32 Schur solves both lie within F32_GAP of the
    float64 solve of the same system (measured at frame 3: cameras 8.0e-4
    JAX, 5.1e-4 port; points 1.8e-3 JAX, 9.9e-4 port)."""
    gaps = []
    for _, _, (args, kw) in port_back_end:
        params, obs, Kt, lam, free = args
        nP, huber = kw["n_points"], kw["huber_px"]
        jp = jba.BAParams(*(jnp.asarray(x.numpy()) for x in params))
        jo = jba.BAObs(*(jnp.asarray(x.numpy()) for x in obs))
        jsys, _ = jba.build_system(jp, jo, jnp.asarray(Kt.numpy()), jnp.asarray(lam.numpy()),
                                   huber, nP, None, True, True)
        jdc, jdp = jba.solve_step_dense(jsys, jo, jnp.asarray(free.numpy()), nP)
        tsys, _ = tba.build_system(params, obs, Kt, lam, huber, nP, None, True, True)
        tdc, tdp = tba.solve_step_dense(tsys, free.float())
        sys64 = tba._System(*(torch.from_numpy(np.array(x)).double() for x in jsys))
        dc64, dp64 = (x.numpy() for x in tba.solve_step_dense(sys64, free.double()))
        for dc, dp in ((np.asarray(jdc), np.asarray(jdp)), (tdc.numpy(), tdp.numpy())):
            gaps.append((float(np.abs(dc - dc64).max()), float(np.abs(dp - dp64).max())))
    assert max(g[0] for g in gaps) <= F32_GAP["cameras"], gaps
    assert max(g[1] for g in gaps) <= F32_GAP["points"], gaps


def test_vo_end_to_end_matches_jax(jax_run):
    """The port's own frontend and back end on the CPU: every frame tracked
    as in the JAX run, keypoint counts within max(2, 2 %), match counts
    within 2, and the final pose within 0.02 (rotation entries) and 0.03
    (translation; the path is 0.36 long) of the JAX run.  (Measured: one
    keypoint differs at frame 3, and the pose then ends 0.019 apart in t.)
    No kernel is launched on CPU tensors."""
    frames, _, steps = jax_run
    reset_launch_counts()
    st = vo_init(torch.from_numpy(frames[0]), K, CFG, VO)
    assert isinstance(st, VOState) and st.X.shape == (3, 32, 3)
    for f, (_, jout, _) in zip(frames[1:], steps):
        st, out = vo_step(st, torch.from_numpy(f), K, CFG, VO)
        assert bool(out.tracked) and bool(jout.tracked)
        assert abs(int(out.n_kp) - int(jout.n_kp)) <= max(2, int(jout.n_kp) // 50)
        assert abs(int(out.n_matches) - int(jout.n_matches)) <= 2
        assert np.isfinite(out.t.numpy()).all() and np.isfinite(float(out.rms_px))
    assert sum(launch_counts().values()) == 0
    assert int(st.frame) == N_FRAMES + 1
    np.testing.assert_allclose(out.R.numpy(), np.asarray(jout.R), atol=0.02)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(jout.t), atol=0.03)


def test_vo_step_with_mask_kernel_equals_default():
    """vo_init + one vo_step with mask_backend="pallas" (K8, its plain
    version here) give the default-mask run's state and output exactly:
    the masks are the same bits."""
    frames = [torch.from_numpy(f) for f in _frames()[:2]]
    runs = []
    for mask_backend in ("xla", "pallas"):
        cfg = dataclasses.replace(CFG, mask_backend=mask_backend)
        st = vo_init(frames[0], K, cfg, VO)
        runs.append(vo_step(st, frames[1], K, cfg, VO))
    (st_a, out_a), (st_b, out_b) = runs
    assert bool(out_a.tracked) and int(out_a.n_matches) > 8
    for a, b in zip(out_a + st_a, out_b + st_b):
        assert torch.equal(a, b)


def test_vo_survives_blank_frame():
    """A blank frame is not tracked, holds the pose and the window map, and
    the next good frame re-localizes (tests/test_vo.py's survival case)."""
    cfg = SiftConfig(kp_per_octave_cap=256)
    vo = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128, pnp_n=128,
                  pnp_iters=6, cg_iters=5)
    from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

    base = synthetic_scene((160 + 48, 160 + 48), n_blobs=40, seed=0)

    def frame_at(dx):
        return torch.from_numpy(np.ascontiguousarray(base[24:184, 24 + dx:184 + dx]))

    Kt = torch.tensor([[200.0, 0, 80.0], [0, 200.0, 80.0], [0, 0, 1.0]])
    st = vo_init(frame_at(0), Kt, cfg, vo)
    st, out1 = vo_step(st, frame_at(2), Kt, cfg, vo)
    assert bool(out1.tracked)
    map_valid_before = st.Xvalid.clone()
    st, out_blank = vo_step(st, torch.zeros((160, 160)), Kt, cfg, vo)
    assert not bool(out_blank.tracked)
    np.testing.assert_allclose(out_blank.t.numpy(), out1.t.numpy(), atol=1e-6)
    assert torch.equal(st.Xvalid, map_valid_before)
    st, out2 = vo_step(st, frame_at(4), Kt, cfg, vo)
    assert bool(out2.tracked) and int(out2.n_matches) > 10 and float(out2.rms_px) < 3.0
    assert int(st.frame) == 4


def test_vo_entry_points_need_a_device():
    """Without a card, a numpy frame and no device raise; device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    frame = _frames()[0]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vo_init(frame, K, CFG, VO)
    st = vo_init(frame, K, CFG, VO, device="cpu")
    assert st.Rs.device.type == "cpu"


@pytest.mark.parametrize("n", [3, 30])
def test_vo_frames_keep_their_shape(n):
    """The profiling frames are (h, w) crops shifted 2 px a frame, also for
    runs longer than the scene's 64-column margin allows."""
    frames = vo_frames((40, 60), n)
    assert len(frames) == n and {f.shape for f in frames} == {(40, 60)}
    np.testing.assert_array_equal(frames[-1][:, :-2], frames[-2][:, 2:])

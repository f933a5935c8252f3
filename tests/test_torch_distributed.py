"""The port's distributed BA (sift_pyocl_tpu_torch/sfm/distributed.py, the
axis_name path of sfm/ba.py) and multi-process bootstrap
(parallel/multihost.py) on the CPU: real gloo ranks, spawned, against the
JAX package's DistributedBA on its virtual CPU mesh and against the port's
own run_ba (tests/test_ba.py's and tests/test_multiprocess.py's
problems)."""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import _torch_ranks
from sift_pyocl_tpu.sfm.distributed import DistributedBA as JaxDistributedBA
from sift_pyocl_tpu.sfm.distributed import merge_points as jax_merge
from sift_pyocl_tpu.sfm.distributed import partition_problem as jax_partition
from sift_pyocl_tpu.sfm.evaluate import ate_rmse, camera_centers
from sift_pyocl_tpu.sfm.synthetic import make_problem, perturb

from sift_pyocl_tpu_torch.parallel import (frames_x_ba_mesh, global_ba_mesh,
                                           initialize_multihost)
from sift_pyocl_tpu_torch.sfm import BAObs, BAParams, DistributedBA, lm_iteration, run_ba
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm.distributed import merge_points, partition_problem
from _torch_threads import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RANK_TIMEOUT_S = 120


def _spawn(target, args_of_rank, world: int = 2) -> dict:
    """_torch_ranks.spawn_ranks with RANK_TIMEOUT_S: {rank: result}; a rank
    that reports an error, exits non-zero or does not finish in time fails
    the test."""
    try:
        return _torch_ranks.spawn_ranks(target, args_of_rank, world, RANK_TIMEOUT_S)
    except AssertionError as e:
        pytest.fail(str(e))


def _rms(params, obs, K) -> float:
    r = tba.residuals(BAParams(*(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                                 for a in params)),
                      BAObs(torch.from_numpy(obs.uv), torch.from_numpy(obs.cam),
                            torch.from_numpy(obs.pt), torch.from_numpy(obs.w)),
                      torch.from_numpy(np.asarray(K, np.float32)))
    return float(r.norm(dim=1).mean())


def _mp_problem():
    """tests/test_multiprocess.py's problem (6 cameras, 96 points)."""
    K, gt, obs, _ = make_problem(n_cams=6, n_points=96, noise_px=0.3, seed=0)
    return K, gt, perturb(gt, rot_deg=2.0, trans=0.05, point_sigma=0.05, seed=1), obs


def _ba_problem():
    """tests/test_ba.py's problem (6 cameras, 120 points)."""
    K, gt, obs, _ = make_problem(n_cams=6, n_points=120, noise_px=0.4, seed=0)
    return K, gt, perturb(gt, rot_deg=2.0, trans=0.12, point_sigma=0.08, seed=1,
                          keep_fixed=(0,)), obs


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_partition_and_merge_match_jax(n_shards):
    """The NumPy copies give JAX's layout exactly, and the round trip of
    tests/test_ba.py::test_partition_roundtrip holds."""
    K, gt, start, obs = _ba_problem()
    small = make_problem(n_cams=6, n_points=96, seed=0)
    for params, ob in ((small[1], small[2]), (start, obs)):
        sp = partition_problem(params, ob, n_shards)
        want = jax_partition(params, ob, n_shards)
        for field in want._fields:
            a, b = getattr(sp, field), getattr(want, field)
            assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, field
        assert int((sp.w > 0).sum()) == len(ob.cam)
        X = merge_points(sp, sp.X, params.X.shape[0])
        np.testing.assert_array_equal(X, params.X)
        np.testing.assert_array_equal(X, jax_merge(want, want.X, params.X.shape[0]))
        for k in range(n_shards):
            assert sp.pt_local[k].max() < sp.pt_rng[k, 1] or sp.pt_rng[k, 1] == 0


def test_lm_iteration_world_size_one_group_is_bit_equal(tmp_path, monkeypatch):
    """With a gloo group of one rank as axis_name, three LM iterations on a
    shard give the bits of axis_name=None, through 4 + cg_iters
    all-reduces an iteration (the cost, U with g_c, the Schur right-hand
    side, one a CG matvec, the candidate's cost)."""
    K, gt, start, obs = _ba_problem()
    sp = partition_problem(start, obs, 1)
    o = BAObs(*(torch.from_numpy(a[0]) for a in (sp.uv, sp.cam, sp.pt_local, sp.w)))
    Kt = torch.from_numpy(K)
    free = torch.arange(6) > 0
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        runs = []
        for group in (None, dist.group.WORLD):
            p = BAParams(torch.from_numpy(start.Rs), torch.from_numpy(start.ts),
                         torch.from_numpy(sp.X[0]))
            lam = torch.tensor(1e-3)
            outs = []
            for _ in range(3):
                p, lam, cost, acc = lm_iteration(p, o, Kt, lam, free, cg_iters=30,
                                                 n_points=sp.p_shard, axis_name=group)
                outs.append((*p, lam, cost, acc))
            runs.append(outs)
    finally:
        dist.destroy_process_group()
    assert len(calls) == 3 * 34
    for it, (a, b) in enumerate(zip(*runs)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"iteration {it}"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both problems through two gloo ranks of the port's DistributedBA, in
    one spawn: {rank: {name: (Rs, ts, X, costs)}}."""
    K, _, start, obs = _mp_problem()
    Kb, _, startb, obsb = _ba_problem()
    cases = {"mp": (K, start, obs, 6), "ba": (Kb, startb, obsb, 15)}
    store = str(tmp_path_factory.mktemp("ranks") / "store")
    return _spawn(_torch_ranks.ba_rank, lambda r: (2, store, cases))


def _ranks_agree(two_ranks, name):
    a, b = two_ranks[0][name], two_ranks[1][name]
    assert a[3] == b[3], "the ranks' costs differ"
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    return a


def test_two_gloo_ranks_match_jax_distributed_ba(two_ranks):
    """Two ranks against the JAX package's DistributedBA on a 2-device
    virtual CPU mesh, tests/test_multiprocess.py's problem, 6 iterations:
    the ranks identical, the first cost within rtol 1e-5, the last within
    5 %.  Measured on the CPU: iteration 1's cost 2.2 % from JAX's (220.36
    against 215.46; JAX's own 1- and 2-device meshes give 223.96 and
    220.36 there, the f32 CG's sums taken in another order), iterations
    2-5 within 4e-4, the last within 5e-6; every iteration is held to 5 %."""
    K, _, start, obs = _mp_problem()
    Rs, ts, X, costs = _ranks_agree(two_ranks, "mp")
    mesh = Mesh(np.array(jax.devices()[:2]), ("ba",))
    pj, costs_j = JaxDistributedBA(mesh).run(start, obs, K, iters=6)
    assert len(costs) == len(costs_j) == 6
    np.testing.assert_allclose(costs[0], costs_j[0], rtol=1e-5)
    assert abs(costs[-1] - costs_j[-1]) / costs_j[-1] < 0.05, (costs[-1], costs_j[-1])
    np.testing.assert_allclose(costs, costs_j, rtol=0.05)
    assert X.shape == np.asarray(pj.X).shape and np.isfinite(X).all()


def test_two_gloo_ranks_match_run_ba(two_ranks):
    """tests/test_ba.py::test_distributed_ba_matches_single on two ranks:
    15 iterations against the port's run_ba on one device; mean
    reprojection error < 0.8, first cost within rtol 1e-5, last within
    5 %, ATE < 0.02."""
    K, gt, start, obs = _ba_problem()
    Rs, ts, X, costs = _ranks_agree(two_ranks, "ba")
    _, costs_s = run_ba(start, obs, K, fixed_cams=(0,), iters=15, device=CPU)
    assert _rms((Rs, ts, X), obs, K) < 0.8
    np.testing.assert_allclose(costs[0], costs_s[0], rtol=1e-5)
    assert abs(costs[-1] - costs_s[-1]) / costs_s[-1] < 0.05
    ate = ate_rmse(camera_centers(Rs, ts), camera_centers(gt.Rs, gt.ts))
    assert ate < 0.02


def test_distributed_ba_in_one_process_is_run_ba():
    """Without a process group DistributedBA is the single-device solver on
    the one shard (its observations sorted by point): the first cost within
    rtol 1e-5, the last within 5 %; the points come back in their order."""
    K, gt, start, obs = _ba_problem()
    dba = DistributedBA(device="cpu")
    assert dba.mesh.group is None and dba.mesh.size == 1
    p, costs = dba.run(start, obs, K, iters=15)
    ps, costs_s = run_ba(start, obs, K, iters=15, device=CPU)
    np.testing.assert_allclose(costs[0], costs_s[0], rtol=1e-5)
    assert abs(costs[-1] - costs_s[-1]) / costs_s[-1] < 0.05
    np.testing.assert_allclose(p.X, ps.X.numpy(), atol=1e-3)
    assert _rms(p, obs, K) < 0.8


def test_initialize_multihost_is_a_noop_in_one_process(monkeypatch):
    for key in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_multihost() == (0, 1)
    assert initialize_multihost(num_processes=1) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")          # one worker named: still a no-op
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert initialize_multihost() == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost("127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="num_processes"):
        initialize_multihost("127.0.0.1:1")


def test_initialize_multihost_takes_torchrun_env():
    """WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT set in two spawned
    processes: initialize_multihost() returns (rank, 2) and the group
    all-reduces; global_ba_mesh is the world group (size 2, the rank).
    env:// is a TCP rendezvous by definition, so this one test takes a free
    port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = _spawn(_torch_ranks.env_rank, lambda r: (2, port))
    for r in (0, 1):
        assert got[r] == (r, 2, 1.0, 2, r), got[r]


def test_meshes():
    """tests/test_checkpoint_multihost.py::test_multihost_helpers_single_process's
    meshes: the BA's mesh in one process (no group, the given device), the
    (2, 4) frames x ba grid over 8 stand-in devices; a count that does not
    divide raises, and without a device the entry points want a card."""
    mesh = global_ba_mesh(device="cpu")
    assert mesh.group is None and mesh.size == 1 and mesh.rank == 0
    assert mesh.device == CPU and mesh.axis_names == ("ba",)
    grid = frames_x_ba_mesh(2, devices=[CPU] * 8)
    assert grid.devices.shape == (2, 4) and grid.axis_names == ("frames", "ba")
    assert all(d == CPU for d in grid.devices.flat)
    with pytest.raises(ValueError, match="not divisible"):
        frames_x_ba_mesh(3, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        for fn in (global_ba_mesh, lambda: frames_x_ba_mesh(1), DistributedBA):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
    with pytest.raises(ValueError, match="not both"):
        DistributedBA(mesh, device="cpu")

"""Rank processes for tests/test_torch_distributed.py and chip_smoke.py's
phase E, and the harness that starts them with the spawn method (this
module imports no JAX and no pytest, so a rank starts in seconds).

Each rank reports on the queue it is given: (rank, result) or (rank,
"error", traceback), so a failing rank fails its caller at once."""

import os
import queue as queue_mod
import time
import traceback


def report(queue, rank, fn):
    """Put (rank, fn()) on the queue, or (rank, "error", traceback) and
    re-raise."""
    try:
        queue.put((rank, fn()))
    except BaseException:            # report, then let the process end
        queue.put((rank, "error", traceback.format_exc()))
        raise


def spawn_ranks(target, args_of_rank, world: int, timeout: float) -> dict:
    """target(rank, *args_of_rank(rank), queue) in `world` processes
    (torch.multiprocessing, spawn); {rank: result}.  A rank that reports an
    error, exits non-zero or has not reported within `timeout` s raises
    AssertionError; every process is ended before returning."""
    import torch

    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args_of_rank(r), q)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for _ in procs:             # drain the queue before joining
            try:
                msg = q.get(timeout=max(deadline - time.monotonic(), 1.0))
            except queue_mod.Empty:
                raise AssertionError(f"ranks did not report within {timeout} s") from None
            assert len(msg) == 2, f"rank {msg[0]} failed:\n{msg[2]}"
            out[msg[0]] = msg[1]
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            assert not p.is_alive() and p.exitcode == 0, f"a rank ended with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return out


def ba_rank(rank: int, world: int, store: str, cases: dict, queue) -> None:
    """Join a gloo group through a file store (explicit arguments to
    initialize_multihost) and run DistributedBA on the CPU for each case
    (name -> (K, params, obs, iters)); report {name: (Rs, ts, X, costs)}."""

    def run():
        import torch
        import torch.distributed as dist

        from sift_pyocl_tpu_torch.parallel import initialize_multihost
        from sift_pyocl_tpu_torch.sfm import DistributedBA

        torch.set_num_threads(1)
        got = initialize_multihost(f"file://{store}", num_processes=world, process_id=rank,
                                   backend="gloo")
        assert got == (rank, world), got
        out = {}
        try:
            for name, (K, params, obs, iters) in cases.items():
                p, costs = DistributedBA(device="cpu").run(params, obs, K, iters=iters)
                out[name] = (p.Rs, p.ts, p.X, costs)
        finally:
            dist.destroy_process_group()
        return out

    report(queue, rank, run)


def env_rank(rank: int, world: int, port: int, queue) -> None:
    """Set torchrun's variables, call initialize_multihost() with no
    arguments, all-reduce the ranks' ids; report (rank, world, sum, mesh
    size, mesh rank)."""

    def run():
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        import torch
        import torch.distributed as dist

        from sift_pyocl_tpu_torch.parallel import global_ba_mesh, initialize_multihost

        got = initialize_multihost()
        try:
            x = torch.tensor([float(rank)])
            dist.all_reduce(x)
            mesh = global_ba_mesh(device="cpu")
            return got + (float(x), mesh.size, mesh.rank)
        finally:
            dist.destroy_process_group()

    report(queue, rank, run)

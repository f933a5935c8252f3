#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit (nvidia-smi).
2. Builds the kernels of sift_pyocl_tpu_torch/csrc/ with nvcc (one process
   per source, all at once).
3. Runs each kernel and its plain PyTorch version on the same inputs at the
   shapes of its path (a 1080x1920 frame) and asserts parity: K1/K2 (blur
   ladders) and K9 (the blur of one plane, at SiftConfig(scales=2)'s five
   octave-0 sigmas) within 1e-3, K3 and K10a (compaction), K8 (extrema
   masks, all 7 octaves; one launch a call) and K7 (best-2 matching, both
   calls of a VO step, each timed and profiled; one launch a call, the same
   bits on two calls) exactly, K4/K10b (refinement, straight from K3's /
   K10a's output; one launch a call) bit for bit, K5, K6, K11a and K11b as
   in their tests; K12 and K13 (csrc/linalg.cu, no Pallas counterpart: the
   two-view init's eigh and svd) at the init's shapes (257 9 x 9 and 3 x 3
   matrices of a 256-row bucket) against torch.linalg.eigh and svd, their
   bounds from the rotations this run's data needs (check_linalg_kernels).
   Times each with CUDA
   events, beside the plain version, a PyTorch library call where one
   computes the same function, and the least time the card could take, and
   counts its CUDA launches and device time a call with torch.profiler
   (cuda_events: the fullest of five sessions).  K2 (one cooperative
   launch, at most 2 allowed) is held bit for bit to K2m's stacks (K2's
   body, with mask items in its work list) on every small octave; K1's
   device time is printed level by level; K3, K6 and K10a make one launch
   a call; K6 gives the same bits on two calls, and its sample iterations
   a valid keypoint are printed (the static window's against its support
   boxes'); K10a is also checked and timed beside torch.nonzero on a
   full-capacity mask (octave 0's shape, density 1e-3, cap 2048, one tile
   past MAX_PER_TILE).
4. Runs SiftPlan((1080, 1920), config=SLICE_CONFIG).keypoints for a few
   frames (the first slice's path, plain pyramid) and holds its keypoints
   to the plain-version path.  SiftPlan on the card replays one CUDA graph
   per (shape, config) (models.sift.DETECT_GRAPHS): for every SiftPlan
   configuration below (plan_frames) the replayed buffer is bit-equal to
   the eager detector's, ms a frame is taken replayed and eager in turns,
   and the kernels' CUDA launches over the replayed frames are read by
   kernel name from torch.profiler's trace (a replay runs no Python) and
   gated with the wrapper calls the counters were gated with before.
5. The main path: vo_init + 10 vo_step at 1080x1920 with SiftConfig() and
   VOConfig().  vo_step on the card replays one CUDA graph per (shape, cfg,
   vo) (utils/graphs.py): 10 eager steps (models.vo._vo_step_eager, every
   frame's keypoint buffer kept) with K1-K6 launched once and K7 twice a
   step, then the same 10 steps through vo_step from an empty graph cache,
   counters reset just before and read just after (the step's body runs
   twice, at the graph's warm-up and capture; replays count nothing), every
   VOState field and VOOut of every step bit-equal to the eager steps',
   every frame tracked with enough matches and a finite pose; the same run
   with plain=True agrees (keypoint counts, tracking, final camera centre,
   rotation).  Prints ms per step eager and replayed in turns (eager,
   replay, replay, eager; median of the warm steps) beside nvidia-smi's
   line, the stage split (eager), device time, launches and top ops of an
   eager and a replayed step; gates the replayed step's CUDA launches of
   K1's, K2's, K3's, K4's, K5's, K6's and K7's kernels and K8's
   (STEP_LAUNCHES, from torch.profiler; P1 and P7 likewise), its total at
   least the plain decode's launches (measured in step 3) below that of
   the host-decode design (LAUNCHES_BEFORE), and its host syncs at 0.
6. P1: the same with SiftConfig(mask_backend="pallas"): K8 once, K1-K6
   once and K7 twice a step, replays bit-equal to eager steps, every
   frame's keypoint buffer equal to the default run's and the final pose
   within 1e-6 of it; ms per replayed step in turns against the default
   mask's, stage split, device time and launches beside the default's.
7. P2: SiftPlan.keypoints with kp_multi_launch=False: K10a, K10b and K6
   launched once per octave a replayed frame, K3-K5 never; its keypoint buffer equal,
   bit for bit, to the multi-launch one with grad_backend="xla".
8. P3: SiftPlan.keypoints with desc_buckets=2: K6 twice a frame; held to its
   plain=True run.
9. P4: SiftPlan.keypoints with SiftConfig(scales=2): octave 0 level by level
   through K9 (5 launches a frame, no K1), K2 once; its octave-0 stacks
   bit-equal to K1's on the same frame and sigmas, its keypoints held to
   its plain=True run.
10. P5: per octave, detection (K10a, K10b), the padded plain gradients,
   assign_orientations_pallas (K11a) and compute_descriptors_pallas
   (K11b), held against K6 and against the plain versions on the same
   keypoints (at most 2 ok-flag flips each: K11a against K6 expected 0),
   and K11b at K6's angles and slots bit-equal to K6's raw descriptors on
   every octave; K11a and K11b one CUDA launch a wrapper call with the
   slot arrays made before it (and timed so beside the closure that makes
   sigma, the rows' earlier form); sample iterations a slot (static window
   against support boxes).
11. P6: SiftPlan.keypoints with kp_backend="xla" (plain PyTorch after the
   K1/K2 pyramid), held to the kernel path's keypoints.
12. K1m/K2m (the mask forms of K1/K2, SiftConfig(mask_backend="fused")) on
   the 1080x1920 frame: blurs and DoGs bit-equal to K1's and K2's, masks
   bit-equal to K8's and to the plain stencil's on those DoGs, all 7
   octaves; against their plain versions (plain ladder + stencil) the
   stacks within 1e-3 and no mask pixel different away from a decision;
   K2m one CUDA launch a call and K1m at most 7; timed and profiled beside
   K1 + K8, K2 + K8 and the plain versions.
13. P7: the main path with SiftConfig(mask_backend="fused"), as step 5:
   K1m and K2m once a step (their kernels gated per replayed step: K2m's
   one cooperative launch, K1m's six level launches and one mask launch),
   K1, K2 and K8 never, the plain stencil never called, K3-K6 once and K7
   twice a step, replays bit-equal to eager steps, every frame's keypoint
   buffer equal to the default run's, final pose within 1e-6; ms per
   replayed step in turns (default, fused, fused, default), stage split and
   device time beside P1's and the default's.
14. SiftPlan.keypoints with SiftConfig(mask_backend="fused", scales=2):
   octave 0 through K9 and the stencil (the fused mask's None fallback),
   octaves >= 1 through K2m; buffer equal to scales=2 without fusion,
   keypoints held to its plain=True run.
15. P8: K7f (f32 operands) through match_descriptors_dense at the VO map
   call's shapes (one frame's 8320 slots against a 2048-slot map from
   another frame): descriptors /512 (exact sums) and /255 (rounded sums),
   d1/d2 within a stated tolerance of the plain version, i1 equal outside
   near-ties (counted); at /512 times 2^18 equal to K7 on the u8
   descriptors bit for bit; the same bits on two calls; one CUDA launch a
   call, of best2_l2_f32_kernel and nothing else (fullest of five profiler
   sessions), whose mean device time is the row's device ms; timed beside
   torch.mm + torch.topk.
16. Phase A, the reference library's API at 1080x1920 (frames: crops of
   the VO scene, the reference at (32, 32)): LinearAlign recovers a (-3,
   +5) translation (matrix within 0.02, offset within 0.3 px, interior
   median error < 2) and a 2 deg / 1.02x affine made with the port's warp;
   shift_only + double_check; relative over 4 frames drifting 2 px (within
   0.8 px); orsa (every returned match an inlier, < 9 px^2);
   MatchPlan(metric="L2") K7 once a replayed match_index (by kernel name),
   indices equal to the CPU's; K1-K6 once per align call (by kernel name:
   the plan's detector replays), the plan's replayed buffer bit-equal to
   its eager one; MatchPlan's matcher graph (L1 and L2, the align's bucket
   pair) and the warp's graph bit-equal to their eager functions.  Prints
   ms per warm align call (host image in, host result out) replayed and
   eager (detector, matcher and warp) in turns and its split (keypoints,
   match, fit, warp; each graph's part replayed and eager), the matchers'
   and the warp's launches, device time and host syncs replayed and
   eager, and the host synchronisations of one call.
17. Phase B: the invariance battery (utils/invariance.py) through the port
   at 256x256: both scenes, all 9 cases against FLOORS, the double_im_size
   zoom fence and the angle fence; both plans' replayed buffers bit-equal
   to their eager ones.
18. Phase C: BASELINE config 4 (tools/bench_configs.py::config4_sfm's
   50-frame sequence, rendered from a seed) through IncrementalSfM three
   times in turns: replayed (the detector, REGISTER_GRAPHS's fused
   registration on the map padded to its power-of-two bucket), eager (the
   eager functions patched in), replayed: each run 50 of 50 frames
   registered, ATE < 0.05, map points within 20 % of 672, a loop edge;
   the replayed runs bit-equal to the eager run in Rs, ts and points; the
   eager run K1-K6 once per frame detected, K7 never; a replayed run at
   most one detector capture and one registration capture a bucket, the
   second none.  Prints each run's wall time, s/frame, phase split
   (periodic BA, loop closure, final BA) and graph captures, and the parts
   of its bootstrap and loop closure (sfm_split: detection, the probe, the
   host matcher, the two-view inits and their count; the loop probe or
   the host loop's matcher and RANSAC-PnP, and the pose graph); one
   registered frame replayed and eager: host ms, CUDA
   launches, device ms and host synchronisations (the replayed frame K1-K6
   once by kernel name), and its split; the BA's segment sum against
   float64.  Then the host loop (IncrementalSfM(fused=False)) replayed
   (its RANSAC-PnP a graph a bucket of matched rows) and eager: at least
   the JAX package's host loop's 50 registered, ATE < 0.05, the runs
   bit-equal, K1-K6 once a frame, K7 never; s/frame and one registered
   frame's launches, device ms and host syncs, replayed and eager, beside
   the fused path's.  The BA's LM iterations replay one graph a BA call
   (ba.LM_GRAPHS, the observations and points padded to their buckets:
   at most 7 keys a run) and the host loop's pair matcher one a bucket
   pair (pipeline.PAIR_GRAPHS); the eager runs patch in their eager
   functions, and the second replayed run of either architecture (the
   host loop runs replayed, eager, replayed) captures nothing in any
   cache.  One LM iteration of each architecture's final BA: replayed
   bit-equal to eager, host ms, CUDA launches, device ms and host syncs
   of both.  The pose graph replays one Gauss-Newton step's graph an
   iteration (posegraph.POSEGRAPH_GRAPHS, one key a run), the fused
   path's bootstrap probe one graph a chunk size and its loop probe one
   on the old map padded to its 64, 128, ... row bucket
   (pipeline.BOOT_PROBE_GRAPHS, LOOP_PROBE_GRAPHS), as the JAX package
   jits them; the host loop probes the loop-closure candidates frame by
   frame (its pair matcher and RANSAC-PnP graphs).  The fused run's
   pose-graph call and loop probe: replayed bit-equal to eager, host ms,
   CUDA launches, device ms and host syncs of both.  The bootstrap's
   two-view inits replay one graph a bucket of matches
   (twoview.TWOVIEW_GRAPHS, the matches padded to 256, 512, ... rows, K12
   and K13 inside); each run's split prints their seconds and calls
   (replayed, or eager in the eager run), and twoview_report one init's
   host ms, CUDA launches, device ms and host syncs replayed and eager
   (the bare replay bit-equal to eager, 0 syncs) and K12's and K13's
   launches a replayed init by kernel name.
19. Phase D: BASELINE config 3, the batched video frontend
   (detect_and_describe_batched) on frames synthetic_scene((1080, 1920),
   n_blobs=200, seed=0) + i on the card, SiftConfig(): at B = 1, 2, 4, 8
   and 12 every frame bit-equal to its single-frame detect_and_describe,
   K1/K2 once a frame and K3, K4, K5, K6 once a batch up to B = 8 (counters
   reset just before each call, and CUDA launches by kernel name from
   torch.profiler), K3-K5 in two launches at B = 12 (84 entries); the
   plain=True batch held frame by frame as step 4 holds the kernel path to
   the plain path; mask_backend="pallas" at B = 4 (K8 once over 28
   entries, frames bit-equal; K8 on a frame's octave 0 at entry 7 takes
   octave 0's edge threshold, not its list position's); "fused" at B = 2
   (K1m/K2m once a frame, no stencil, frames bit-equal); VideoSiftFrontend
   (batch 4; the detector's graph replayed a frame) on the one-card mesh
   and TwoStagePipeline over 6 frames (a graph a stage), host frames in,
   eager (the counters: every frontend kernel once a frame) and replayed
   (the same launches by kernel name), each frame bit-equal to its eager
   buffer and to detect_and_describe.  Prints ms/frame at each B (host
   clock, synchronised, warm; B = 1, 8, 8, 1 in turns), device ms and CUDA
   launches a batch, and the video and pipeline ms/frame replayed and
   eager in turns with their launches and device ms a frame.
20. Phase E: BASELINE config 5, the distributed BA, on bench_distributed.py's
   problem (make_problem(n_cams=64, n_points=8192, noise_px=0.5, seed=0,
   arc_deg=150.0), ~5e5 observations; ts + 0.02 N, X + 0.10 N), 10 LM
   iterations.  E1: DistributedBA over an NCCL group of world size 1 in
   this process against run_ba on the same problem: first cost within rtol
   1e-5 and last within 5 % (the outer bounds), every iteration's cost
   within rtol 1e-6, the reprojection error falling, 34 all-reduces an
   iteration (4 + cg_iters).  E2: two ranks spawned (torch.multiprocessing,
   spawn) on cuda:0 over gloo, after a probe of whether NCCL takes two
   ranks on one card (its answer printed, not gated): both ranks' costs
   and results identical, their costs against E1's with the same outer
   bounds and every iteration's within rtol 1e-4; a rank that fails or has not reported in time fails the
   phase.  E3: parallel.sharded_scale_space of the 1080x1920 frame on
   (cuda:0,) x 2 and x 4 against the plain single-device pyramid: blurs
   within 2e-3, DoGs within 4e-3.  Prints ms a warm LM iteration at 1 and
   2 ranks (host clock, synchronised) beside run_ba's, all-reduces, host
   syncs, CUDA launches and device ms an iteration (and its costliest
   kernels), the host's ms in all_reduce calls a warm iteration (a run
   after NCCL's communicator is made), each run's largest relative cost
   difference, and ms a pyramid call
   beside the plain pyramid's.  One card shows the collective pattern and
   its parity, not scaling across cards.
21. Phase F: the 200-frame VO fence (tests/test_vo_longrun.py's 224x224
   blob-cloud orbit and settings; utils/longrun.py) through vo_init /
   vo_step on the kernels, vo_step replaying its graph (captured once, at
   the first step): the reference test's asserts (finite state every 25
   frames, tracked >= 0.95, 0.45 < path ratio < 2.5, ATE < 0.35, RSS growth
   < 500 MB), no kernel library built or loaded and no carried shape
   changed after frame 2, memory_allocated flat within 1 MiB from frame 2
   to the last, the step's body run twice (warm-up and capture), a replayed
   step launching each kernel once and K7 twice (torch.profiler); then the
   same run with the eager step, whose tracked, ATE and path ratio the
   graph's equal.  Prints ms a warm step (median) of both runs, tracked,
   ATE, path ratio, max_memory_allocated.
22. Phase G: BASELINE config 2 (tools/bench_configs.py's config2_*),
   pairwise 1080p matching: the pair (a frame and its vertical flip:
   detect, L2 ratio match at 0.5329^2, RANSAC-H) with its match and fit
   equal to the plain match's on the same buffers and rows; a sequence of
   crops moving (3, -4) px a frame, each detected once and fitted against
   the previous frame's buffer, every H within 4 px of the translation at
   the corners (set from the plain run: its f32 fit, not the kernels), the
   inliers a median < 0.2 px from it, >= 100 inliers; K1-K6 once a
   detection, K7 once a match; ms of pair, seq and the stages with their
   launches and device ms.
23. Phase H: the evaluate CLI on the card over config 4's frames written as
   PGM and TUM files (save_sequence), read by the native loader: sfm mode
   50 of 50 registered, ATE < 0.12; vo mode (vo_step's graph) ATE < 0.17
   (twice the JAX package's 0.0848 on the same files); each mode's JSON
   line equal to its eager run's on the same files (sfm mode: every graph
   of phase C's patched to its eager function).
24. Prints the card's nvidia-smi line again, a JSON line of per-kernel
   results (18 rows, launches from the path that runs each kernel: on
   the VO paths the wrapper calls of the replayed steps, from a replayed
   step's device profile, with capture_launches the wrappers' counters
   over the graph's warm-up and capture; K10a/K10b on P2 and K9 on P4
   from their replayed frames' device profiles; K12/K13 on phase C's
   first replayed run, its inits times a replayed init's launches by
   name; config3_launches for K3-K6 and K8 from phase D, cuda_launches and
   device_ms a wrapper call from the profiler), then, as its last line,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SHAPE = (1080, 1920)
FRAMES = 3
VO_STEPS = 10
MIN_KEYPOINTS = 200
ROOT = "sift_pyocl_tpu"
# Published peaks of one H100 SXM (dense): HBM bytes/s, f32 outside the
# tensor cores, int8 tensor-core operations/s.
HBM_BPS = 3.35e12
STARTED = time.perf_counter()
F32_OPS = 67e12
INT8_OPS = 1979e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_events(fn, calls: int = 5, sessions: int = 5) -> list:
    """The kernels, memsets and copies on the card that torch.profiler
    records over `calls` calls of fn() (after one more), from the one of
    `sessions` profiling sessions that recorded the most (a lost record
    only ever lowers a count); each session opens with profiling.PREROLL
    spin kernels, which take the first records that torch.profiler drops."""
    from torch.profiler import ProfilerActivity, profile

    from sift_pyocl_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiling.open_session()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = profiling.device_events(prof)
        if len(events) > len(best):
            best = events
    return best


def device_ms(fn, name: str, calls: int = 5) -> float:
    """Device ms per fn() call spent in CUDA kernels whose names contain
    `name` (torch.profiler), apart from the host's time between launches."""
    return sum(e.device_time_total for e in cuda_events(fn, calls)
               if name in e.name) / 1e3 / calls


def launch_device_ms(fn, name: str, calls: int = 5) -> list:
    """Device ms of each launch of the kernels named `name` in one fn()
    call, in launch order, averaged over `calls` calls (torch.profiler)."""
    ev = sorted((e for e in cuda_events(fn, calls) if name in e.name),
                key=lambda e: e.time_range.start)
    per = len(ev) // calls
    return [sum(ev[c * per + i].device_time_total for c in range(calls)) / 1e3 / calls
            for i in range(per)]


def kernel_launch_ms(fn, name: str, calls: int = 5):
    """(recorded launches a call, mean device ms a launch) of the kernels
    named `name` in fn() (torch.profiler, cuda_events).  A lost record
    lowers the count but not the mean, so for a kernel launched once a call
    the mean is its device time a call even where profile_calls reads low."""
    ev = [e for e in cuda_events(fn, calls) if name in e.name]
    return len(ev) / calls, (sum(e.device_time_total for e in ev) / 1e3 / len(ev)
                             if ev else float("nan"))


def profile_calls(fn, wrapper_calls: int = 1, calls: int = 5):
    """(CUDA launches, device ms) per wrapper call in fn(): the kernels,
    memsets and copies on the card that torch.profiler records
    (cuda_events), and the sum of their durations (the device's own time,
    apart from the host's time between launches); fn() makes
    `wrapper_calls` wrapper calls."""
    events = cuda_events(fn, calls)
    n = calls * wrapper_calls
    return len(events) / n, sum(e.device_time_total for e in events) / 1e3 / n


def host_ms(fn, calls: int = 5) -> float:
    """Host-clock ms a call of fn(), synchronised, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / calls


def bound(n_bytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops over
    the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BPS, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Kernels:
    """Per-kernel records for the final JSON line."""

    def __init__(self):
        self.rows = {}

    def record(self, name, source, replaces, err, fn, ref, iters, n_bytes, ops,
               peak_ops=F32_OPS, library=None, wrapper_calls=1):
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(ref, max(2, iters // 4))
        library_ms = cuda_ms(library, iters) if library is not None else None
        bound_ms, bound_by = bound(n_bytes, ops, peak_ops)
        launches, dev_ms = profile_calls(fn, wrapper_calls)
        self.rows[name] = {"name": name, "route": "cuda", "source": source,
                           "replaces": replaces, "max_abs_err": float(err), "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": library_ms, "cuda_launches": launches,
                           "device_ms": dev_ms * wrapper_calls}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"{name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms (device {dev_ms * wrapper_calls:.4f})"
              f"  plain {plain_ms:.4f} ms  library {lib} ms  bound {bound_ms:.4f} ms ({bound_by})"
              f"  CUDA launches a call {launches:g}", flush=True)
        return self.rows[name]


def window_samples(fr, fc, sigma, valid, win: int, oct_h, oct_w, angles=None, ok=None):
    """The window samples the histogram kernels (K6, K11a, K11b) read, over
    the valid slots: those inside the keypoint's octave (oct_h x oct_w: ints
    or per-slot tensors) and inside the orientation circle d2 <
    floor(4.5 sigma)^2 + 0.5, or inside the descriptor's rotated square at
    each ok angle of angles (n, k).  Returns (circle, squares summed over
    the ok angles, union of the circle and the squares), the counts of
    this run's keypoints."""
    from sift_pyocl_tpu_torch.oracle import DESC_GRID, MAG_FACTOR
    from sift_pyocl_tpu_torch.ops.kernels.window import _offsets, window_origin

    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    ar = torch.arange(win, device=fr.device)
    n_circle = n_square = n_union = 0
    todo = torch.nonzero(valid.bool()).squeeze(1)
    for k0 in range(0, todo.numel(), 256):
        ks = todo[k0:k0 + 256]
        rr, cc = _offsets(fro[ks], fco[ks], win)
        sig = sigma[ks].float()[:, None, None]
        radius = torch.floor(3.0 * (1.5 * sig))
        circle = rr * rr + cc * cc < radius * radius + 0.5
        h = oct_h if isinstance(oct_h, int) else oct_h[ks].long()[:, None]
        w = oct_w if isinstance(oct_w, int) else oct_w[ks].long()[:, None]
        r, c = rs[ks].long()[:, None] + ar, cs[ks].long()[:, None] + ar
        inb = ((r >= 0) & (r < h))[:, :, None] & ((c >= 0) & (c < w))[:, None, :]
        union = circle & inb
        n_circle += int(union.sum())
        for k in range(0 if angles is None else angles.shape[1]):
            a = angles[ks, k].float()[:, None, None]
            spacing = MAG_FACTOR * sig
            rbin = (torch.cos(a) * rr - torch.sin(a) * cc) / spacing + (DESC_GRID / 2.0 - 0.5)
            cbin = (torch.sin(a) * rr + torch.cos(a) * cc) / spacing + (DESC_GRID / 2.0 - 0.5)
            square = ((rbin > -1.0) & (rbin < DESC_GRID) & (cbin > -1.0) & (cbin < DESC_GRID)
                      & inb & ok[ks, k][:, None, None])
            n_square += int(square.sum())
            union |= square
        n_union += int(union.sum())
    return n_circle, n_square, n_union


def _conv_calls(octaves, taps_of):
    """The plain pyramid's cuDNN conv2d calls alone, on inputs padded ahead
    of time: one (input, kernel) pair per horizontal and vertical pass."""
    import torch.nn.functional as F

    calls = []
    for blurs, taps in zip(octaves, taps_of):
        for lvl, t in zip(blurs, taps):
            half = (t.numel() - 1) // 2
            x = F.pad(lvl[None, None], (half, half, 0, 0), mode="replicate")
            calls.append((x, t.view(1, 1, 1, -1)))
            y = F.pad(lvl[None, None], (0, 0, half, half), mode="replicate")
            calls.append((y, t.view(1, 1, -1, 1)))
    return lambda: [F.conv2d(x, k) for x, k in calls]


def check_ladders(x: torch.Tensor, cfg, rec: Kernels) -> None:
    """K1 and K2 against their plain versions on the main path's pyramid."""
    from sift_pyocl_tpu_torch.ops.kernels import ladder, maskk
    from sift_pyocl_tpu_torch.ops.pyramid import _taps, downsample_octave, normalize_image

    data = normalize_image(x)
    pre = float(np.sqrt(cfg.init_sigma**2 - cfg.orig_sigma**2))
    incs = cfg.sigma_increments()
    n_oct = cfg.n_octaves(SHAPE)
    b0, d0 = ladder.octave0_ladder(data, pre, incs)
    rb0, rd0 = ladder.octave0_ladder_ref(data, pre, incs)
    base = downsample_octave(rb0[cfg.scales], cfg.downsample_mode)
    small = ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, cfg.downsample_mode)
    rsmall = ladder.small_octaves_ladder_ref(base, incs, n_oct - 1, cfg.scales,
                                             cfg.downsample_mode)
    # K2 against K2m (K2's body, with mask items in its work list), bit for bit
    eths = tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct))
    k2m = ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, cfg.downsample_mode,
                                      mask_cfg=(cfg.peak_thresh, eths, cfg.border_dist))
    torch.cuda.synchronize()
    for o, ((b, d), (mb, md, _)) in enumerate(zip(small, k2m)):
        assert torch.equal(b, mb) and torch.equal(d, md), f"K2's octave {o + 1} differs from K2m's"
    print(f"small_octaves_ladder: blurs and DoGs bit-equal to K2m's on octaves 1-{n_oct - 1}",
          flush=True)
    err1 = max(float((b0 - rb0).abs().max()), float((d0 - rd0).abs().max()))
    err2 = max(max(float((a - b).abs().max()), float((c - d).abs().max()))
               for (a, c), (b, d) in zip(small, rsmall))
    assert [tuple(b.shape) for b, _ in small] == [tuple(b.shape) for b, _ in rsmall]
    assert err1 <= 1e-3 and err2 <= 1e-3, f"ladders differ: K1 {err1}, K2 {err2}"

    all_taps = [_taps(float(s), x.device) for s in (pre,) + incs]
    k_sum = sum(t.numel() for t in all_taps)
    h, w = SHAPE
    n_lv = len(incs)
    rec.record("octave0_ladder", "sift_pyocl_tpu_torch/csrc/ladder.cu",
               f"{ROOT}/ops/pallas/ladder0.py:256", err1,
               lambda: ladder.octave0_ladder(data, pre, incs),
               lambda: ladder.octave0_ladder_ref(data, pre, incs), 20,
               n_bytes=4 * h * w * (1 + (n_lv + 1) + n_lv), ops=2 * 2 * k_sum * h * w,
               library=_conv_calls([[data] + list(rb0[:-1])], [all_taps]))
    k_inc = sum(t.numel() for t in all_taps[1:])
    px = sum(b.shape[1] * b.shape[2] for b, _ in rsmall)
    row = rec.record("small_octaves_ladder", "sift_pyocl_tpu_torch/csrc/ladder.cu",
                     f"{ROOT}/ops/pallas/ladder.py:421", err2,
                     lambda: ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales,
                                                         cfg.downsample_mode),
                     lambda: ladder.small_octaves_ladder_ref(base, incs, n_oct - 1, cfg.scales,
                                                             cfg.downsample_mode), 20,
                     n_bytes=4 * (base.numel() + px * (2 * n_lv + 1)), ops=2 * 2 * k_inc * px,
                     library=_conv_calls([list(b[:-1]) for b, _ in rsmall],
                                         [all_taps[1:]] * len(rsmall)))
    assert row["cuda_launches"] <= 2, f"K2 made {row['cuda_launches']} CUDA launches a call"
    k1 = rec.rows["octave0_ladder"]
    k1["level_device_ms"] = launch_device_ms(lambda: ladder.octave0_ladder(data, pre, incs),
                                             "blur_level_kernel")
    assert len(k1["level_device_ms"]) == n_lv + 1, k1["level_device_ms"]
    print(f"octave0_ladder: device ms a level (taps {[t.numel() for t in all_taps]}): "
          f"{[round(v, 5) for v in k1['level_device_ms']]}", flush=True)
    # what K2's steps cost with next to no work: the same 6 octaves and 20
    # steps from a 64 x 64 base (one tile a pass), against the main path's
    tiny = base[:64, :64].contiguous()
    floor_ms = profile_calls(lambda: ladder.small_octaves_ladder(
        tiny, incs, n_oct - 1, cfg.scales, cfg.downsample_mode))[1]
    table, blocks = ladder._small_plan(tuple(ladder._geometry(*base.shape, n_oct - 1)),
                                       tuple(map(float, incs)), cfg.scales, x.device)[:2]
    print(f"small_octaves_ladder: {int(table[0])} steps on {blocks} blocks; device "
          f"{row['device_ms']:.4f} ms at {tuple(base.shape)}, {floor_ms:.4f} ms from a 64 x 64 "
          f"base (the steps' floor)", flush=True)
    row["floor_device_ms"] = floor_ms


def check_keypoint_kernels(x: torch.Tensor, cfg, rec: Kernels) -> None:
    """K3-K6 against their plain versions at the frontend's shapes."""
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    from sift_pyocl_tpu_torch.ops.detect import decode_compacted, extrema_mask
    from sift_pyocl_tpu_torch.ops.kernels import compact, gradpad, refine, window
    from sift_pyocl_tpu_torch.ops.orient_desc import _desc_window_size, quantize_descriptors
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space

    octaves = build_scale_space(x, cfg)
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    dogs = [d for _, d in octaves]
    blurs = [b for b, _ in octaves]
    masks = [extrema_mask(d, cfg, o) for o, d in enumerate(dogs)]
    torch.cuda.synchronize()
    n_slots = sum(caps)

    # K3: exact (np.nonzero order, same written/total)
    got = compact.compact_masks_multi(masks, caps)
    want = compact.compact_masks_multi_ref(masks, caps)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), (got[1:], want[1:])
    assert int(want[1].sum()) >= MIN_KEYPOINTS, f"too few candidates: {want[1].tolist()}"
    off, err = 0, 0
    for o, cap in enumerate(caps):
        w = int(want[1][o])
        err = max(err, int((got[0][off:off + w] - want[0][off:off + w]).abs().max().item()) if w else 0)
        off += cap
    assert err == 0, f"compaction differs by {err}"
    row = rec.record("compact_masks_multi", "sift_pyocl_tpu_torch/csrc/compact.cu",
                     f"{ROOT}/ops/pallas/compact.py:252", float(err),
                     lambda: compact.compact_masks_multi(masks, caps),
                     lambda: compact.compact_masks_multi_ref(masks, caps), 50,
                     n_bytes=sum(m.numel() for m in masks) + 4 * n_slots, ops=0,
                     library=lambda: [torch.nonzero(m) for m in masks])
    assert row["cuda_launches"] == 1, f"K3 made {row['cuda_launches']} CUDA launches a call"

    # K4, straight from K3's output: bit-equal to its plain version (same
    # decode, same operation order, no FMA contraction)
    idx, written, _ = got
    args = (dogs, masks, caps, idx, written, cfg.border_dist, cfg.peak_thresh,
            cfg.max_interp_moves)
    got = refine.refine_multi(*args)
    want = refine.refine_multi_ref(*args)
    torch.cuda.synchronize()
    for f, g, w in zip(("s_int", "fs", "fr", "fc", "peak", "keep"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f"K4's {f} differs from its plain version"
    err = max(float((g - w).abs().max()) for g, w in zip(got[1:5], want[1:5]))
    n_valid = int(written.sum())
    # least work: idx and written read once, the six outputs (21 bytes a
    # slot) written once, one 19-sample solve (about 120 operations) per
    # valid candidate
    row = rec.record("refine_multi", "sift_pyocl_tpu_torch/csrc/refine.cu",
                     f"{ROOT}/ops/pallas/refine.py:334", err,
                     lambda: refine.refine_multi(*args), lambda: refine.refine_multi_ref(*args),
                     50, n_bytes=n_slots * (4 + 21) + 4 * len(caps) + n_valid * 19 * 4,
                     ops=n_valid * 120)
    assert row["cuda_launches"] == 1, f"K4 made {row['cuda_launches']} CUDA launches a call"
    # what the launches a step fall by: the plain decode the kernel took in
    row["decode_cuda_launches"] = profile_calls(
        lambda: decode_compacted(dogs, masks, caps, idx, written, cfg.border_dist))[0]
    print(f"refine_multi: bit-equal to its plain version, {n_valid} valid candidates, "
          f"{int(want[5].sum())} kept; the plain decode it replaces makes "
          f"{row['decode_cuda_launches']:g} CUDA launches", flush=True)
    s, fs, fr, fc, _, kvalid = got

    # K5: mag within 1e-5, ori within 1e-5 modulo 2 pi
    got = gradpad.grad_atlas(blurs, cfg.scales)
    want = gradpad.grad_atlas_ref(blurs, cfg.scales)
    assert got[2] == want[2]
    err_m = float((got[0] - want[0]).abs().max())
    d = (got[1] - want[1]).abs()
    err_o = float(torch.minimum(d, 2 * np.pi - d).max())
    err = max(err_m, err_o)
    assert err <= 1e-5, f"gradient atlas differs: mag {err_m}, ori {err_o}"
    plane_px = sum(b.shape[1] * b.shape[2] for b in blurs)
    rec.record("grad_atlas", "sift_pyocl_tpu_torch/csrc/gradpad.cu",
               f"{ROOT}/ops/pallas/gradpad.py:168", err,
               lambda: gradpad.grad_atlas(blurs, cfg.scales),
               lambda: gradpad.grad_atlas_ref(blurs, cfg.scales), 50,
               n_bytes=4 * cfg.scales * plane_px + 2 * got[0].numel() * 4,
               ops=cfg.scales * plane_px * 30)
    mag, ori, row_starts = got

    # K6: same ok flags (up to near-tie peaks), angles within 1e-4, u8
    # descriptors within 1 count (the kernel and the plain version sum the
    # bins in different orders)
    sigma = cfg.init_sigma * 2.0 ** (fs / cfg.scales)
    win = _desc_window_size(cfg)
    wargs = (mag, ori, s, fr, fc, sigma, kvalid, win, cfg.max_ori,
             *window.slot_octave_geometry(caps, row_starts, blurs))
    ang_k, ok_k, raw_k = window.orient_desc_fused(*wargs)
    ang_p, ok_p, raw_p = window.orient_desc_fused_ref(*wargs)
    n_ok = int(ok_p.sum())
    mismatch = int((ok_k != ok_p).sum())
    assert n_ok >= MIN_KEYPOINTS and mismatch <= max(1, n_ok // 500), f"ok flags: {mismatch} of {n_ok} differ"
    both = ok_k & ok_p
    da = (ang_k[both] - ang_p[both]).abs()
    err_a = float(torch.minimum(da, 2 * np.pi - da).max())
    dq = (quantize_descriptors(raw_k[both]).int() - quantize_descriptors(raw_p[both]).int()).abs()
    unit = raw_p[both] / raw_p[both].norm(dim=1, keepdim=True).clamp(min=1e-30)
    unit_k = raw_k[both] / raw_k[both].norm(dim=1, keepdim=True).clamp(min=1e-30)
    err = float((unit_k - unit).abs().max())
    n_kv = int(kvalid.sum())
    print(f"orient_desc_fused: {n_kv} valid keypoints, {n_ok} ok slots, {mismatch} ok flags "
          f"differ, angle err {err_a:.3g}, u8 desc diff max {int(dq.max())} mean "
          f"{float(dq.float().mean()):.4g}")
    assert err_a <= 1e-4 and int(dq.max()) <= 1 and float(dq.float().mean()) < 0.01
    # least work: each valid keypoint reads the (mag, ori) samples of its
    # orientation circle and descriptor squares once; about 10 operations a
    # circle sample for the histogram and 20 a square sample for each
    # orientation's descriptor
    n_circle, n_square, n_union = window_samples(fr, fc, sigma, kvalid, win, *wargs[-2:],
                                                 angles=ang_k, ok=ok_k)
    row = rec.record("orient_desc_fused", "sift_pyocl_tpu_torch/csrc/window.cu",
                     f"{ROOT}/ops/pallas/window.py:688", err,
                     lambda: window.orient_desc_fused(*wargs),
                     lambda: window.orient_desc_fused_ref(*wargs), 20,
                     n_bytes=n_slots * 29 + n_union * 8 + raw_k.numel() * 4 + 5 * ok_k.numel(),
                     ops=n_circle * 10 + n_square * 20)
    assert row["cuda_launches"] == 1, f"K6 made {row['cuda_launches']} CUDA launches a call"
    # the same bits on every call
    again = window.orient_desc_fused(*wargs)
    for a, b in zip((ang_k, ok_k, raw_k), again):
        assert torch.equal(a, b), "K6 differs between two calls on the same inputs"
    # sample iterations a valid keypoint: the static-window design walked
    # the whole window once for the orientations and once a descriptor; the
    # kernel walks the orientation box and, at each ok angle, the 25 quad
    # boxes (window.support_boxes)
    kv = kvalid.nonzero().flatten()
    geo = (wargs[-2][kv], wargs[-1][kv])
    ori_it = window.box_samples(window.support_boxes(fr[kv], fc[kv], sigma[kv], win, *geo))
    desc_it = torch.zeros_like(ori_it)
    for o in range(cfg.max_ori):
        q = window.support_boxes(fr[kv], fc[kv], sigma[kv], win, *geo, angle=ang_k[kv, o])
        desc_it += torch.where(ok_k[kv, o], window.box_samples(q).sum(1), 0)
    before = win * win * (1 + ok_k[kv].sum(1)).double().mean()
    after = (ori_it + desc_it).double().mean()
    row["sample_iterations_per_keypoint"] = [float(before), float(after)]
    print(f"orient_desc_fused: bit-identical across two calls; sample iterations a valid "
          f"keypoint {float(before):.0f} (static {win}^2 window a pass) -> {float(after):.0f} "
          f"(support boxes: orientation {float(ori_it.double().mean()):.0f}, descriptors "
          f"{float(desc_it.double().mean()):.0f}), {float(before / after):.2f}x fewer", flush=True)


def check_mask_kernels(x: torch.Tensor, cfg, rec: Kernels) -> None:
    """K8 over all octaves, K10a and K10b on octave 0, against their plain
    versions at the shapes of their paths (P1, P2)."""
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    from sift_pyocl_tpu_torch.ops.kernels import compact, maskk, refine
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space

    dogs = [d for _, d in build_scale_space(x, cfg)]
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    got = maskk.extrema_masks(dogs, cfg)
    want = maskk.extrema_masks_ref(dogs, cfg)
    torch.cuda.synchronize()
    assert len(got) == len(want) == cfg.n_octaves(SHAPE)
    for o, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"K8 differs from the plain stencil in octave {o}"
    n_cand = [int(w.sum()) for w in want]
    mask_px = sum(w.numel() for w in want)
    print(f"extrema_masks: equal on all {len(want)} octaves, candidates {n_cand}", flush=True)
    # least work: each DoG value read once, each mask byte written once;
    # about 70 operations a mask element (52 neighbour compares, the
    # strength test and the 2x2 Hessian edge test)
    rec.record("extrema_masks", "sift_pyocl_tpu_torch/csrc/maskk.cu",
               f"{ROOT}/ops/pallas/maskk.py:194", 0.0,
               lambda: maskk.extrema_masks(dogs, cfg),
               lambda: maskk.extrema_masks_ref(dogs, cfg), 50,
               n_bytes=4 * sum(d.numel() for d in dogs) + mask_px, ops=70 * mask_px)
    assert rec.rows["extrema_masks"]["cuda_launches"] == 1, "K8 made more than one CUDA launch"

    mask, cap = want[0], caps[0]
    got = compact.compact_mask(mask, cap)
    ref = compact.compact_mask_ref(mask, cap)
    torch.cuda.synchronize()
    for g, w in zip(got, ref):
        assert g.shape == w.shape and torch.equal(g, w), "K10a differs from its plain version"
    print(f"compact_mask: exact; written {int(ref[1])}, total {int(ref[2])}", flush=True)
    row = rec.record("compact_mask", "sift_pyocl_tpu_torch/csrc/compact.cu",
                     f"{ROOT}/ops/pallas/compact.py:99", 0.0,
                     lambda: compact.compact_mask(mask, cap),
                     lambda: compact.compact_mask_ref(mask, cap), 50,
                     n_bytes=mask.numel() + 4 * cap + 8, ops=0,
                     library=lambda: torch.nonzero(mask))
    assert row["cuda_launches"] == 1, f"K10a made {row['cuda_launches']} CUDA launches a call"
    row["library_device_ms"] = profile_calls(lambda: torch.nonzero(mask))[1]
    print(f"torch.nonzero on the same mask: device {row['library_device_ms']:.4f} ms", flush=True)
    row.update(check_full_compaction(mask.shape, cap, x.device))

    # K10b, straight from K10a's output: bit-equal to its plain version
    args = (dogs[0], mask, got[0], got[1], cfg.border_dist, cfg.peak_thresh,
            cfg.max_interp_moves)
    got = refine.refine_octave(*args)
    ref = refine.refine_octave_ref(*args)
    torch.cuda.synchronize()
    for f, g, w in zip(("s_int", "fs", "fr", "fc", "peak", "keep"), got, ref):
        assert g.dtype == w.dtype and torch.equal(g, w), f"K10b's {f} differs from the plain one"
    err = max(float((g - w).abs().max()) for g, w in zip(got[1:5], ref[1:5]))
    n_valid = int(args[3])
    row = rec.record("refine_octave", "sift_pyocl_tpu_torch/csrc/refine.cu",
                     f"{ROOT}/ops/pallas/refine.py:394", err,
                     lambda: refine.refine_octave(*args), lambda: refine.refine_octave_ref(*args),
                     50, n_bytes=cap * (4 + 21) + 4 + n_valid * 19 * 4, ops=n_valid * 120)
    assert row["cuda_launches"] == 1, f"K10b made {row['cuda_launches']} CUDA launches a call"


def check_full_compaction(shape, cap: int, dev) -> dict:
    """K10a at full capacity: octave 0's mask shape under SiftConfig(), a
    seeded mask of density 1e-3 (about 32 set bytes a tile, so the cap cuts
    the octave), one tile holding 200 set bytes (past MAX_PER_TILE);
    exact against its plain version, timed beside torch.nonzero.  Returns
    the figures the compact_mask row carries as full_*."""
    from sift_pyocl_tpu_torch.ops.kernels import compact

    rng = np.random.default_rng(0)
    host = rng.random(shape) < 1e-3
    flat = host.reshape(-1)
    t = 5 * compact.TILE
    flat[t:t + compact.TILE] = False
    flat[t + rng.choice(compact.TILE, 200, replace=False)] = True
    mask = torch.from_numpy(host).to(dev)
    got = compact.compact_mask(mask, cap)
    ref = compact.compact_mask_ref(mask, cap)
    torch.cuda.synchronize()
    for g, w in zip(got, ref):
        assert g.shape == w.shape and torch.equal(g, w), "K10a differs at full capacity"
    assert int(ref[1]) == cap < int(ref[2]), (int(ref[1]), int(ref[2]))
    ms = cuda_ms(lambda: compact.compact_mask(mask, cap), 50)
    library_ms = cuda_ms(lambda: torch.nonzero(mask), 50)
    bound_ms, _ = bound(mask.numel() + 4 * cap + 8, 0, F32_OPS)
    launches, dev_ms = profile_calls(lambda: compact.compact_mask(mask, cap))
    _, lib_dev_ms = profile_calls(lambda: torch.nonzero(mask))
    print(f"compact_mask (full capacity, {tuple(shape)}, {int(ref[2])} set, cap {cap}): exact; "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}), torch.nonzero {library_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}), bound {bound_ms:.4f} ms, CUDA launches a call {launches:g}",
          flush=True)
    assert launches == 1
    return {"full_ms": ms, "full_device_ms": dev_ms, "full_library_ms": library_ms,
            "full_library_device_ms": lib_dev_ms, "full_bound_ms": bound_ms,
            "full_set": int(ref[2])}


def check_matcher(buf, rec: Kernels) -> None:
    """K7 against its plain version at both calls of a VO step, with the
    main path's row validity: the frame's 8320 keypoint slots against a
    2048-slot map of 8 blocks of 256 valid keypoints, and the frame's 256
    strongest valid keypoints (vo_step's spawn rows) against its 8320 slots
    (the keyframe).  Each call: the same bits on two calls, one CUDA
    launch, its event and device time, bound and library time
    (torch.mm + torch.topk); the row's main figures are the map call's,
    the keyframe call's are its keyframe_* keys."""
    from sift_pyocl_tpu_torch.ops.kernels import matchk

    rng = np.random.default_rng(0)
    valid_ids = torch.nonzero(buf.valid).flatten().cpu().numpy()
    blocks = [rng.choice(valid_ids, 256, replace=False) for _ in range(8)]
    map_ids = torch.from_numpy(np.concatenate(blocks)).to(buf.desc.device)
    map_desc = buf.desc[map_ids].clone()
    map_valid = buf.valid[map_ids].clone()
    spawn_ids = torch.sort(torch.where(buf.valid, buf.scale, -torch.inf), descending=True,
                           stable=True).indices[:256]
    spawn = buf.desc[spawn_ids].clone()
    spawn_valid = buf.valid[spawn_ids].clone()
    assert bool(map_valid.all()) and bool(spawn_valid.all())
    cases = [("map", buf.desc, map_desc, map_valid, buf.valid),
             ("keyframe", spawn, buf.desc, buf.valid, spawn_valid)]
    calls = {}
    for tag, d1, d2, v2, v1 in cases:
        got = matchk.best2_l2(d1, d2, v2, v1)
        again = matchk.best2_l2(d1, d2, v2, v1)
        want = matchk.best2_l2_ref(d1, d2, v2)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g[v1], w[v1]), f"K7 ({tag}) differs on valid rows"
            assert torch.equal(g, a), f"K7 ({tag}) gave other bits on a second call"
        a32, b32 = d1.float(), d2.float()
        n_rows, n_cols = int(v1.sum()), int(v2.sum())
        launches, dev_ms = profile_calls(lambda: matchk.best2_l2(d1, d2, v2, v1))
        assert launches == 1, f"K7 ({tag}) made {launches} CUDA launches a call"
        # least work: each input read once, the outputs written once; 2 x
        # 128 integer operations for each (valid row, valid column) pair
        bound_ms, bound_by = bound(d1.numel() + d2.numel() + v1.numel() + v2.numel()
                                   + 12 * d1.shape[0], 2 * 128 * n_rows * n_cols, INT8_OPS)
        calls[tag] = {
            "d1": d1, "d2": d2, "v1": v1, "v2": v2, "n_rows": n_rows, "n_cols": n_cols,
            "ms": cuda_ms(lambda: matchk.best2_l2(d1, d2, v2, v1), 50),
            "device_ms": dev_ms, "cuda_launches": launches,
            "plain_ms": cuda_ms(lambda: matchk.best2_l2_ref(d1, d2, v2), 12),
            "library_ms": cuda_ms(lambda: torch.topk(torch.mm(a32, b32.T), 2, dim=1,
                                                     largest=False), 50),
            "bound_ms": bound_ms, "bound_by": bound_by}
        c = calls[tag]
        print(f"best2_l2 ({tag}, {d1.shape[0]} x {d2.shape[0]}, {n_rows} valid rows, {n_cols} "
              f"valid columns): equal on valid rows, the same bits on two calls; kernel "
              f"{c['ms']:.4f} ms (device {dev_ms:.4f}, CUDA launches a call {launches:g}), plain "
              f"{c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    m = calls["map"]
    d1, d2, v2, v1 = m["d1"], m["d2"], m["v2"], m["v1"]
    a32, b32 = d1.float(), d2.float()

    def library():
        torch.topk(torch.mm(a32, b32.T), 2, dim=1, largest=False)

    row = rec.record("best2_l2", "sift_pyocl_tpu_torch/csrc/matchk.cu",
                     f"{ROOT}/ops/pallas/matchk.py:113", 0.0,
                     lambda: matchk.best2_l2(d1, d2, v2, v1),
                     lambda: matchk.best2_l2_ref(d1, d2, v2), 50,
                     n_bytes=d1.numel() + d2.numel() + v1.numel() + v2.numel()
                     + 12 * d1.shape[0], ops=2 * 128 * m["n_rows"] * m["n_cols"],
                     peak_ops=INT8_OPS, library=library)
    assert row["cuda_launches"] == 1, f"K7 made {row['cuda_launches']} CUDA launches a call"
    k = calls["keyframe"]
    row.update({f"keyframe_{f}": k[f] for f in ("ms", "device_ms", "cuda_launches", "plain_ms",
                                                "library_ms", "bound_ms", "bound_by")})


# Each kernel's CUDA launches are read by name from torch.profiler's trace
# (a replayed graph runs no Python, so the wrappers' counters miss it): the
# pattern of each kernel's name, and each wrapper's kernels with their
# launches a wrapper call (K1 and K1m launch six level kernels, K1m also
# K8's mask kernel; K9 launches K1's level kernel; K3 and K10a share the
# compaction kernel, K4 and K10b the refinement kernel).
KERNEL_PATTERNS = {k: rf"\b{k}\b" for k in (
    "small_octaves_kernel", "small_octaves_kernel_masks", "compact_kernel", "refine_kernel",
    "grad_kernel", "orient_desc_kernel", "orientation_hist_kernel", "descriptor_hist_kernel",
    "mask_kernel", "best2_l2_kernel", "best2_l2_f32_kernel", "sym_eig_small_kernel",
    "svd3_kernel")}
KERNEL_PATTERNS["blur_level_kernel"] = r"\bblur_level(_any)?_kernel\b"
WRAPPER_KERNELS = {
    "octave0_ladder": {"blur_level_kernel": 6},
    "octave0_ladder_mask": {"blur_level_kernel": 6, "mask_kernel": 1},
    "small_octaves_ladder": {"small_octaves_kernel": 1},
    "small_octaves_ladder_mask": {"small_octaves_kernel_masks": 1},
    "separable_blur": {"blur_level_kernel": 1}, "compact_masks_multi": {"compact_kernel": 1},
    "compact_mask": {"compact_kernel": 1}, "refine_multi": {"refine_kernel": 1},
    "refine_octave": {"refine_kernel": 1}, "grad_atlas": {"grad_kernel": 1},
    "orient_desc_fused": {"orient_desc_kernel": 1},
    "orientation_hist": {"orientation_hist_kernel": 1},
    "descriptor_hist": {"descriptor_hist_kernel": 1}, "extrema_masks": {"mask_kernel": 1},
    "best2_l2": {"best2_l2_kernel": 1}, "best2_l2_f32": {"best2_l2_f32_kernel": 1},
    "sym_eig_small": {"sym_eig_small_kernel": 1}, "svd3": {"svd3_kernel": 1}}


def kernel_counts(fn, calls: int = 1) -> dict:
    """Each hand-written kernel's CUDA launches over `calls` calls of fn()
    (after one more), by name from torch.profiler's trace: the fullest of
    three sessions (utils/profiling.py::kernel_launches)."""
    from sift_pyocl_tpu_torch.utils.profiling import kernel_launches

    per_call = kernel_launches(fn, KERNEL_PATTERNS.values(), calls)
    return {k: round(calls * per_call[pat], 6) for k, pat in KERNEL_PATTERNS.items()}


def check_wrapper_launches(tag: str, got: dict, wrappers: dict) -> dict:
    """Gate kernel launches (kernel_counts) against the wrapper calls
    `wrappers` (every other wrapper never called); returns `wrappers` with
    every other wrapper at 0, the path's wrapper calls."""
    want = {k: 0 for k in KERNEL_PATTERNS}
    for name, n in wrappers.items():
        for k, per in WRAPPER_KERNELS[name].items():
            want[k] += per * n
    assert got == want, f"{tag}: CUDA launches {got}, want {want} (wrapper calls {wrappers})"
    return {name: wrappers.get(name, 0) for name in WRAPPER_KERNELS}


@contextlib.contextmanager
def eager_programs():
    """Every program the port replays as a graph outside the VO step, as
    its eager function (the references of the replayed runs), for an eager
    turn: SiftPlan's detector, the fused registration, the host loop's
    RANSAC-PnP and pair matcher, the SfM bundle adjustment's LM iterations,
    the pose graph's Gauss-Newton steps, the fused path's bootstrap and
    loop-closure probes and two-view inits, MatchPlan's matcher,
    LinearAlign's warp, the video frontend's frames and the two pipeline
    stages."""
    from sift_pyocl_tpu_torch.models import match_align
    from sift_pyocl_tpu_torch.models.sift import SiftPlan
    from sift_pyocl_tpu_torch.ops import match, transform
    from sift_pyocl_tpu_torch.parallel import pipeline_octaves, video
    from sift_pyocl_tpu_torch.sfm import ba, pipeline, pnp, posegraph, twoview

    def eager_raw(self, image):
        img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
        return self._fn(img.to(self.device))

    patches = [(SiftPlan, "keypoints_raw", eager_raw),
               (pipeline, "register_from_buffers", pipeline._register_from_buffers_eager),
               (pipeline, "ransac_pnp", pnp._ransac_pnp_eager),
               (pipeline, "match_packed", match._match_packed_eager),
               (pipeline, "run_ba", ba._run_ba_eager),
               (pipeline, "optimize_pose_graph", posegraph._optimize_pose_graph_eager),
               (pipeline, "boot_probe", pipeline._boot_probe_eager),
               (pipeline, "loop_probe", pipeline._loop_probe_eager),
               (pipeline, "initialize_two_view", twoview._initialize_two_view_eager),
               (match_align, "match_packed", match._match_packed_eager),
               (match_align, "affine_warp", transform._affine_warp_eager),
               (video, "_device_share", video.batched_sift),
               (pipeline_octaves, "stage0", pipeline_octaves._stage0_eager),
               (pipeline_octaves, "stage1", pipeline_octaves._stage1_eager)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def check_buffers_equal(tag: str, got, want) -> None:
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{tag}: {name}"
        assert torch.equal(g, w), f"{tag}: {name} differs in {int((g != w).sum())} places"


def plan_frames(tag: str, plan, img, frames: int = FRAMES):
    """A SiftPlan on the card: its detector graph captured (a first call)
    and its replayed buffer bit-equal to the eager detector's on the frame;
    then `frames` calls of plan.keypoints replayed and eager in turns
    (eager, replay, replay, eager; host image in, records out) and the
    kernels' CUDA launches over `frames` replayed calls (kernel_counts).
    Returns (last records, replayed ms per frame, launches, eager ms per
    frame)."""
    from sift_pyocl_tpu_torch.models.sift import DETECT_GRAPHS

    x = torch.from_numpy(img).to(plan.device)
    captures = DETECT_GRAPHS.captures
    kp = plan.keypoints(img)
    check_buffers_equal(f"{tag}: replay against eager", plan.keypoints_raw(img), plan._fn(x))
    turns = {"eager": [], "replay": []}
    for turn in ("eager", "replay", "replay", "eager"):
        ctx = eager_programs() if turn == "eager" else contextlib.nullcontext()
        with ctx:
            plan.keypoints(img)
            torch.cuda.synchronize()
            for _ in range(frames):
                t = time.perf_counter()
                kp = plan.keypoints(img)
                turns[turn].append(1e3 * (time.perf_counter() - t))
    counts = kernel_counts(lambda: plan.keypoints(img), frames)
    new = DETECT_GRAPHS.captures - captures
    print(f"{tag}: replayed buffer bit-equal to the eager detector's ({new} capture); "
          f"ms/frame replayed {[round(m, 3) for m in turns['replay']]}, "
          f"eager {[round(m, 3) for m in turns['eager']]}; memory reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB", flush=True)
    return kp, turns["replay"], counts, turns["eager"]


def check_slice_frontend(img, x, dev) -> dict:
    """The first slice's path: SiftPlan.keypoints under SLICE_CONFIG."""
    from sift_pyocl_tpu_torch import SLICE_CONFIG, SiftPlan, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    cfg = SLICE_CONFIG
    kp, frame_ms, launches, _ = plan_frames("SLICE_CONFIG", SiftPlan(SHAPE, config=cfg,
                                                                      device=dev), img)
    print("SLICE_CONFIG CUDA launches over", FRAMES, "replayed frames:", launches, flush=True)
    counts = check_wrapper_launches("SLICE_CONFIG", launches, {
        name: FRAMES for name in ("compact_masks_multi", "refine_multi", "grad_atlas",
                                  "orient_desc_fused")})
    assert len(kp) >= MIN_KEYPOINTS, f"only {len(kp)} keypoints"
    for f in ("x", "y", "scale", "angle"):
        assert np.isfinite(kp[f]).all(), f
    assert kp["desc"].shape == (len(kp), 128)
    print(f"SiftPlan{SHAPE}.keypoints (SLICE_CONFIG): {len(kp)} keypoints, ms/frame "
          f"{[round(m, 3) for m in frame_ms]} (mean {np.mean(frame_ms):.3f})", flush=True)
    ref = to_keypoint_records(detect_and_describe(x, cfg, plain=True))
    hits, l1 = match_keypoint_sets(ref, kp)
    print(f"plain path: {len(ref)} keypoints, kernel path {len(kp)}, matched {hits}, "
          f"desc L1 {l1:.4f}", flush=True)
    assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
    assert hits >= 0.98 * len(ref) and l1 < 0.1
    return counts


def _camera_centre(R, t):
    return -(R.T @ t)


@contextlib.contextmanager
def frontend_recorder(bufs: list):
    """Keeps every KeypointBuffer that vo_init / vo_step take from the
    frontend, so that two VO runs can be compared frame by frame."""
    from sift_pyocl_tpu_torch.models import vo as vo_mod

    frontend = vo_mod.detect_and_describe

    def recorded(img, cfg, plain=False):
        buf = frontend(img, cfg, plain=plain)
        bufs.append(buf)
        return buf

    vo_mod.detect_and_describe = recorded
    try:
        yield bufs
    finally:
        vo_mod.detect_and_describe = frontend


def run_vo(imgs, K, cfg, vo, plain: bool, bufs=None, eager: bool = False):
    """vo_init + VO_STEPS steps; returns (states, outs, step ms, init
    counts), a state and an output for each step.  The steps are vo_step's
    (on the card one CUDA graph; the first step of a key new to
    STEP_GRAPHS captures it), or with `eager` the eager step's.  With a
    list `bufs` (eager or plain only: a replay runs no Python), every
    frame's KeypointBuffer goes in it."""
    from sift_pyocl_tpu_torch import vo_init, vo_step
    from sift_pyocl_tpu_torch.models.vo import _vo_step_eager
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    if bufs is not None and not (eager or plain):
        raise ValueError("keypoint buffers are recorded from eager steps only")
    step = _vo_step_eager if eager else vo_step
    with frontend_recorder([] if bufs is None else bufs):
        reset_launch_counts()
        state = vo_init(imgs[0], K, cfg, vo, plain=plain)
        init_counts = launch_counts()
        torch.cuda.synchronize()
        reset_launch_counts()
        states, outs, ms = [], [], []
        for img in imgs[1:VO_STEPS + 1]:
            t = time.perf_counter()
            state, out = step(state, img, K, cfg, vo, plain=plain)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            states.append(state)
            outs.append(out)
    return states, outs, ms, init_counts


def timed_vo_steps(imgs, K, cfg, vo, eager: bool = False):
    """vo_init + VO_STEPS steps (vo_step, or with `eager` the eager step);
    per step the wall ms (synchronised) and the host thread's CPU ms."""
    from sift_pyocl_tpu_torch import vo_init, vo_step
    from sift_pyocl_tpu_torch.models.vo import _vo_step_eager

    step = _vo_step_eager if eager else vo_step
    state = vo_init(imgs[0], K, cfg, vo)
    torch.cuda.synchronize()
    wall, cpu = [], []
    for img in imgs[1:VO_STEPS + 1]:
        t, c = time.perf_counter(), time.thread_time()
        state, _ = step(state, img, K, cfg, vo)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))
        cpu.append(1e3 * (time.thread_time() - c))
    return wall, cpu


VO_KERNELS = ("octave0_ladder", "small_octaves_ladder", "compact_masks_multi", "refine_multi",
              "grad_atlas", "orient_desc_fused", "best2_l2")


FUSED_LADDERS = ("octave0_ladder_mask", "small_octaves_ladder_mask")
# The step's Python body runs twice in a run of vo_step on a key new to the
# graph cache: the warm-up on the capture stream and the capture.  The
# wrappers count there (a launch into the stream, then into the graph); a
# replay runs no Python, and its launches are read from torch.profiler.
GRAPH_BODIES = 2


def check_vo_counts(init_counts, counts, extra=(), ladders=VO_KERNELS[:2], bodies=VO_STEPS):
    """The ladders (K1/K2, or `ladders`), K3-K6 (and `extra`) once in
    vo_init and once in each of `bodies` runs of the step's body, K7 twice,
    every other kernel never."""
    on_path = tuple(ladders) + VO_KERNELS[2:] + tuple(extra)
    for name, n in init_counts.items():
        want = 1 if name in on_path and name != "best2_l2" else 0
        assert n == want, f"vo_init: {name} launched {n} times (want {want})"
    for name, n in counts.items():
        want = (2 if name == "best2_l2" else 1) * bodies if name in on_path else 0
        assert n == want, f"{name} launched {n} times in {bodies} step bodies (want {want})"


# Per-step CUDA launches of the hand-written kernels on a VO path (kernel
# name substrings in torch.profiler's trace of a replayed step): K2's one
# cooperative launch and K3's one launch, where the per-level design
# launched 35 level and downsample kernels (and a copy) for K2 and three
# kernels (and a fill) for K3; K1's six level launches; K5's one launch; K6's
# one launch, where its wrapper launched 12 more; K7's one launch a call (map
# and keyframe), where its wrapper cast both valid masks first; K8's one
# launch on P1; K4's one launch, where its wrapper cast the valid mask and
# its caller decoded K3's output in ~100 small launches.  On P7, K2m is
# small_octaves_kernel_masks (one launch, was 41.6 a call), and K1m is K1's
# six level launches and one launch of K8's mask_kernel.
STEP_LAUNCHES = {"small_octaves_kernel": 1, "compact_kernel": 1,
                 "blur_level_kernel": 6, "grad_kernel": 1, "orient_desc_kernel": 1,
                 "best2_l2_kernel": 2, "mask_kernel": 0, "refine_kernel": 1}
STEP_LAUNCHES_P1 = {**STEP_LAUNCHES, "mask_kernel": 1}
STEP_LAUNCHES_FUSED = {**STEP_LAUNCHES, "mask_kernel": 1}
# CUDA launches a step with the host-side decode before K4 (this script on
# an H100 at 1080x1920): the main path, P1 and P7 (2680 with K2m's earlier
# per-level design before that).
LAUNCHES_BEFORE = {"main path": 3548, "P1": 2639, "P7": 2639}


# Each VO-path wrapper's kernel (a name substring in torch.profiler's
# trace) and its CUDA launches a wrapper call: K1 and K1m launch six level
# kernels a call (K1m's mask launch is counted by the levels), K2m's kernel
# is small_octaves_kernel_masks.
GRAPH_PATH_KERNELS = {"octave0_ladder": ("blur_level_kernel", 6),
                      "small_octaves_ladder": ("small_octaves_kernel", 1),
                      "compact_masks_multi": ("compact_kernel", 1),
                      "refine_multi": ("refine_kernel", 1), "grad_atlas": ("grad_kernel", 1),
                      "orient_desc_fused": ("orient_desc_kernel", 1),
                      "best2_l2": ("best2_l2_kernel", 1), "extrema_masks": ("mask_kernel", 1),
                      "octave0_ladder_mask": ("blur_level_kernel", 6),
                      "small_octaves_ladder_mask": ("small_octaves_kernel", 1)}


def graph_path_calls(name: str, replay_launches: dict) -> int:
    """A VO-path wrapper's calls in one replayed step, from that step's
    gated CUDA launches by kernel name (check_step_launches)."""
    kernel, per_call = GRAPH_PATH_KERNELS[name]
    calls, rest = divmod(replay_launches[kernel], per_call)
    assert calls > 0 and rest == 0, f"{name}: {replay_launches[kernel]} launches of {kernel}"
    return calls


def check_kernel_launches(tag: str, by_name: dict, want: dict) -> dict:
    """Gate the launches of each kernel in `want` (name substrings) in a
    profile's launches by name; returns them."""
    got = {k: sum(n for name, n in by_name.items() if k in name) for k in want}
    assert got == want, f"{tag}: launches a step {got}, want {want}"
    return got


def check_step_launches(tag: str, prof: dict, want: dict, decode_launches: float) -> dict:
    """Gate a VO path's per-step launches of each kernel in `want` (from the
    device profile of a replayed step), and its total: at least
    `decode_launches` (the plain decode's CUDA launches, measured in this
    run) below LAUNCHES_BEFORE[tag]; returns the gated launches."""
    by_name = prof.pop("launches_by_name_per_frame")
    total = prof["kernel_launches_per_frame"]
    got = check_kernel_launches(tag, by_name, want)
    print(f"{tag}: CUDA launches a replayed step {total:.0f} (was {LAUNCHES_BEFORE[tag]}, the "
          f"decode alone {decode_launches:g}); of the hand-written kernels {got}", flush=True)
    assert total <= LAUNCHES_BEFORE[tag] - decode_launches, \
        f"{tag}: {total} CUDA launches a step, not {decode_launches} below {LAUNCHES_BEFORE[tag]}"
    return got


def host_syncs(fn) -> list:
    """The host synchronisations fn() makes (sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the first detection also brings a notice that the mode is a prototype
    return [str(c.message).splitlines()[0] for c in caught
            if "called a synchronizing" in str(c.message)
            and not str(c.message).startswith("Synchronization debug mode")]


def check_tracked(outs, vo):
    for i, o in enumerate(outs):
        assert bool(o.tracked), f"frame {i + 1} not tracked"
        assert int(o.n_matches) >= vo.min_track_matches, f"frame {i + 1}: {int(o.n_matches)} matches"
        assert torch.isfinite(o.R).all() and torch.isfinite(o.t).all(), f"frame {i + 1}: pose"


def check_steps_equal(tag: str, states, outs, want_states, want_outs) -> None:
    """Every VOState field and VOOut of every step bit-equal."""
    assert len(states) == len(want_states) == len(outs) == len(want_outs) == VO_STEPS
    for i, pairs in enumerate(zip(states, outs, want_states, want_outs)):
        got_s, got_o, want_s, want_o = pairs
        for name, g, w in zip(got_s._fields + got_o._fields, (*got_s, *got_o),
                              (*want_s, *want_o)):
            assert g.dtype == w.dtype and g.shape == w.shape, f"{tag} step {i + 1}: {name}"
            assert torch.equal(g, w), \
                f"{tag} step {i + 1}: {name} differs in {int((g != w).sum())} places"


def _ms(ms) -> str:
    return (f"median {np.median(ms[1:]):.3f} (mean {np.mean(ms[1:]):.3f}, range "
            f"{min(ms[1:]):.3f}-{max(ms[1:]):.3f})")


def drive_vo_path(tag: str, cfg, vo, imgs, K, want: dict, decode_launches: float,
                  count_kw: dict) -> dict:
    """One VO path at 1080x1920 (`tag`: "main path", P1 or P7): VO_STEPS
    eager steps with their counters and every frame's keypoint buffer; the
    same steps through vo_step from an empty graph cache with their counters
    (the body runs at the warm-up and the capture only), every state field
    and output bit-equal to the eager steps'; eager and replayed ms a step in
    turns (eager, replay, replay, eager), beside nvidia-smi's line; the
    stage split (eager: its stage callbacks are host calls); an eager step's
    and a replayed step's device profile, the replayed step's per-kernel
    launches gated by `want` and its total by LAUNCHES_BEFORE; a replayed
    step's host syncs (none)."""
    from sift_pyocl_tpu_torch import vo_step
    from sift_pyocl_tpu_torch.models.vo import STEP_GRAPHS, _vo_step_eager
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts
    from sift_pyocl_tpu_torch.utils import profiling

    run_vo(imgs[:3], K, cfg, vo, plain=False, eager=True)    # warm-up: allocator, cuDNN
    bufs = []
    estates, eouts, ems, einit = run_vo(imgs, K, cfg, vo, plain=False, bufs=bufs, eager=True)
    ecounts = launch_counts()
    print(f"{tag}: launch counts over {VO_STEPS} eager steps:", ecounts, flush=True)
    check_vo_counts(einit, ecounts, **count_kw)
    STEP_GRAPHS.clear()
    captures = STEP_GRAPHS.captures
    states, outs, step_ms, init_counts = run_vo(imgs, K, cfg, vo, plain=False)
    counts = launch_counts()
    print(f"{tag}: launch counts over {VO_STEPS} vo_step (the graph's warm-up and capture; "
          f"replays count nothing):", counts, flush=True)
    check_vo_counts(init_counts, counts, bodies=GRAPH_BODIES, **count_kw)
    assert STEP_GRAPHS.captures == captures + 1 and len(STEP_GRAPHS) == 1
    check_steps_equal(tag, states, outs, estates, eouts)
    check_tracked(outs, vo)
    print(f"{tag}: {VO_STEPS} replayed steps bit-equal to the eager steps in every VOState "
          f"field and VOOut; vo_step {SHAPE} ms (host clock, synchronised; the first "
          f"captures): {[round(m, 3) for m in step_ms]}; eager "
          f"{[round(m, 3) for m in ems]}", flush=True)
    turns = {"eager": [], "replay": []}
    smi = nvidia_smi_line()
    for turn in ("eager", "replay", "replay", "eager"):
        gc.collect()
        wall, cpu = timed_vo_steps(imgs, K, cfg, vo, eager=turn == "eager")
        turns[turn].append(float(np.median(wall[1:])))
        print(f"  {tag} turn {turn}: warm ms/step {_ms(wall)}, host thread CPU ms/step "
              f"{np.mean(cpu[1:]):.3f}  [{smi}]", flush=True)
    rest = iter(imgs[VO_STEPS + 1:])
    state, stages = profiling.vo_stage_ms(states[-1], [next(rest) for _ in range(3)], K, cfg, vo)
    print(f"{tag}: vo stage split (eager step, device ms, CUDA events):",
          {k: round(v, 3) for k, v in stages.items()}, flush=True)
    box = [state]

    def one(step):
        box[0], _ = step(box[0], next(rest), K, cfg, vo)

    eager_prof = profiling.device_profile(lambda: one(_vo_step_eager), 1, sessions=2)
    eager_prof.pop("launches_by_name_per_frame")
    prof = profiling.device_profile(lambda: one(vo_step), 1, sessions=2)
    replay_launches = check_step_launches(tag, prof, want, decode_launches)
    for name, p in (("eager step", eager_prof), ("replayed step", prof)):
        print(f"{tag}: {name}: device ms {p['kernel_ms_per_frame']:.3f}, CUDA launches "
              f"{p['kernel_launches_per_frame']:.0f}, busy share {p['busy_share']:.3f}; top ops "
              f"{json.dumps([[n, round(ms, 4)] for n, ms in p['top_kernels_ms_per_frame']])}",
              flush=True)
    syncs = host_syncs(lambda: one(vo_step))
    print(f"{tag}: host synchronisations in one replayed vo_step: {len(syncs)}", flush=True)
    for line in sorted(set(syncs)):
        print("  sync:", line[:160])
    assert not syncs, f"{tag}: a replayed step synchronised the host {len(syncs)} times"
    return {"counts": counts, "replay_launches": replay_launches, "bufs": bufs, "outs": outs,
            "step_ms": step_ms, "stages": stages, "profile": prof, "eager_profile": eager_prof,
            "turns": turns}


def check_vo(dev, decode_launches: float) -> dict:
    """The main path: vo_init + VO_STEPS vo_step at 1080x1920, defaults
    (drive_vo_path), and the plain path beside it.  Returns what P1 and P7
    are compared with: the frames, K, counts, every frame's keypoint buffer
    (eager), the outputs, step ms, stage split, device profile and
    `decode_launches` (check_step_launches)."""
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig
    from sift_pyocl_tpu_torch.utils import profiling

    cfg, vo = SiftConfig(), VOConfig()
    h, w = SHAPE
    K = torch.tensor([[1000.0, 0, w / 2], [0, 1000.0, h / 2], [0, 0, 1]], device=dev)
    host = profiling.vo_frames(SHAPE, VO_STEPS + 12)
    imgs = [torch.from_numpy(f).to(dev) for f in host]
    run = drive_vo_path("main path", cfg, vo, imgs, K, STEP_LAUNCHES, decode_launches, {})
    outs = run["outs"]
    print("n_kp", [int(o.n_kp) for o in outs], "n_matches", [int(o.n_matches) for o in outs],
          "rms_px", [round(float(o.rms_px), 3) for o in outs], flush=True)

    # the kernel path against the plain path on the same card
    _, pouts, pms, _ = run_vo(imgs, K, cfg, vo, plain=True)
    for i, (o, p) in enumerate(zip(outs, pouts)):
        assert abs(int(o.n_kp) - int(p.n_kp)) <= max(2, int(p.n_kp) // 50), (i, int(o.n_kp), int(p.n_kp))
        assert bool(o.tracked) == bool(p.tracked), i
    c_k = _camera_centre(outs[-1].R, outs[-1].t)
    c_p = _camera_centre(pouts[-1].R, pouts[-1].t)
    travelled = float(torch.linalg.vector_norm(c_p))
    dc = float(torch.linalg.vector_norm(c_k - c_p))
    cos = float(((outs[-1].R @ pouts[-1].R.T).trace() - 1) / 2)
    rot_deg = math.degrees(math.acos(max(-1.0, min(1.0, cos))))
    print(f"plain path: n_kp {[int(p.n_kp) for p in pouts]}, centre {c_p.tolist()}, "
          f"kernel path centre {c_k.tolist()}; centre gap {dc:.4g} of {travelled:.4g} travelled, "
          f"rotation gap {rot_deg:.4g} deg; plain ms/step {np.mean(pms[1:]):.3f}", flush=True)
    assert dc <= 0.05 * travelled, f"camera centre {dc} apart over {travelled}"
    assert rot_deg <= 0.1, f"rotation {rot_deg} deg apart"
    print("vo_step device profile (a replay):", json.dumps(run["profile"]), flush=True)
    return {**run, "imgs": imgs, "K": K, "decode_launches": decode_launches}


def check_vo_against_base(tag: str, run: dict, base: dict) -> float:
    """A mask backend's run against the default's on the same frames: every
    frame's keypoint buffer equal, the final pose within 1e-6."""
    assert len(run["bufs"]) == len(base["bufs"]) == VO_STEPS + 1
    for i, (a, b) in enumerate(zip(run["bufs"], base["bufs"])):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f"{tag} frame {i}: {f} differs"
    outs = run["outs"]
    gap = max(float((outs[-1].R - base["outs"][-1].R).abs().max()),
              float((outs[-1].t - base["outs"][-1].t).abs().max()))
    assert gap <= 1e-6, f"{tag}: final pose {gap} from the default mask's run"
    print(f"{tag}: {VO_STEPS} frames tracked, every keypoint buffer equal to the default "
          f"mask's, final pose {gap:.3g} apart", flush=True)
    return gap


def mask_turns(tags_cfgs, imgs, K, vo) -> None:
    """Two mask backends' replayed steps in turns (a, b, b, a) in this one
    process: warm steps' wall ms and the host thread's CPU ms."""
    for tag, turn_cfg in tags_cfgs:
        gc.collect()
        wall, cpu = timed_vo_steps(imgs, K, turn_cfg, vo)
        print(f"  turn {tag} (replayed): warm ms/step {_ms(wall)}, host thread CPU ms/step "
              f"{np.mean(cpu[1:]):.3f}", flush=True)


def print_vo_paths(runs) -> None:
    for tag, run in runs:
        ms, dev_prof = run["step_ms"], run["profile"]
        print(f"  {tag}: replayed ms/step warm {_ms(ms)}; eager stage split "
              f"{({k: round(v, 3) for k, v in run['stages'].items()})}; device ms/step "
              f"{dev_prof['kernel_ms_per_frame']:.3f} (eager "
              f"{run['eager_profile']['kernel_ms_per_frame']:.3f}), launches/step "
              f"{dev_prof['kernel_launches_per_frame']:.0f} (eager "
              f"{run['eager_profile']['kernel_launches_per_frame']:.0f}), busy share "
              f"{dev_prof['busy_share']:.3f}", flush=True)


def check_vo_k8(base: dict) -> dict:
    """P1: the main path with SiftConfig(mask_backend="pallas"), against the
    default mask's run of check_vo on the same frames."""
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig

    cfg, vo = SiftConfig(mask_backend="pallas"), VOConfig()
    imgs, K = base["imgs"], base["K"]
    run = drive_vo_path("P1", cfg, vo, imgs, K, STEP_LAUNCHES_P1, base["decode_launches"],
                        {"extra": ("extrema_masks",)})
    check_vo_against_base("P1", run, base)
    mask_turns((("default", SiftConfig()), ("K8", cfg), ("K8", cfg), ("default", SiftConfig())),
               imgs, K, vo)
    print_vo_paths((("default mask", base), ("K8 mask", run)))
    return run


def check_per_octave(img, dev) -> dict:
    """P2: SiftPlan.keypoints with kp_multi_launch=False."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan

    cfg = SiftConfig(kp_multi_launch=False)
    n_oct = cfg.n_octaves(SHAPE)
    plan = SiftPlan(SHAPE, config=cfg, device=dev)
    multi = SiftPlan(SHAPE, config=SiftConfig(grad_backend="xla"), device=dev)
    kp, frame_ms, launches, _ = plan_frames("P2", plan, img)
    print(f"P2 (kp_multi_launch=False) CUDA launches over {FRAMES} replayed frames:", launches,
          flush=True)
    counts = check_wrapper_launches("P2", launches, {
        name: n * FRAMES for name, n in (("compact_mask", n_oct), ("refine_octave", n_oct),
                                         ("orient_desc_fused", n_oct), ("octave0_ladder", 1),
                                         ("small_octaves_ladder", 1))})
    assert len(kp) >= MIN_KEYPOINTS, f"only {len(kp)} keypoints"
    got, want = plan.keypoints_raw(img), multi.keypoints_raw(img)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"P2: {f} differs from multi-launch"
    print(f"P2: {len(kp)} keypoints, buffer equal bit for bit to multi-launch with "
          f"grad_backend='xla'; ms/frame {[round(m, 3) for m in frame_ms]}", flush=True)
    return counts


def check_buckets(img, x, dev) -> dict:
    """P3: SiftPlan.keypoints with desc_buckets=2, against its plain run."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import _desc_buckets, to_keypoint_records
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    cfg = SiftConfig(desc_buckets=2)
    assert _desc_buckets(cfg) is not None, "desc_buckets=2 would make one launch"
    kp, frame_ms, launches, _ = plan_frames("P3", SiftPlan(SHAPE, config=cfg, device=dev), img)
    print(f"P3 (desc_buckets=2) CUDA launches over {FRAMES} replayed frames:", launches,
          flush=True)
    counts = check_wrapper_launches("P3", launches, {"orient_desc_fused": 2 * FRAMES,
                                                     **{n: FRAMES for n in VO_KERNELS[:5]}})
    ref = to_keypoint_records(detect_and_describe(x, cfg, plain=True))
    hits, l1 = match_keypoint_sets(ref, kp)
    print(f"P3: {len(kp)} keypoints, plain path {len(ref)}, matched {hits}, desc L1 {l1:.4f}; "
          f"ms/frame {[round(m, 3) for m in frame_ms]}", flush=True)
    assert len(kp) >= MIN_KEYPOINTS
    assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
    assert hits >= 0.98 * len(ref) and l1 < 0.1
    return counts


def check_blur(x: torch.Tensor, rec: Kernels) -> None:
    """K9 against its plain version on the per-level octave 0 of
    SiftConfig(scales=2) at 1080x1920 (the pre-blur and four increments,
    each on the level before it), and that route's octave-0 blur and DoG
    stacks against K1's on the same frame and sigmas: bit-equal, since K9
    launches K1's level kernel."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.kernels import conv, ladder
    from sift_pyocl_tpu_torch.ops.pyramid import (_taps, build_octave, normalized_input,
                                                  pre_blur_sigma, prepare_input,
                                                  separable_blur_ref)

    cfg = SiftConfig(scales=2)
    pre, incs = pre_blur_sigma(cfg), cfg.sigma_increments()
    blurs, dogs = build_octave(prepare_input(x, cfg, "pallas"), incs, "pallas")
    k1_blurs, k1_dogs = ladder.octave0_ladder(normalized_input(x, cfg), pre, incs)
    torch.cuda.synchronize()
    assert torch.equal(blurs, k1_blurs) and torch.equal(dogs, k1_dogs), \
        "the per-level octave 0 differs from K1's"
    print(f"P4: per-level octave 0 (5 K9 launches) bit-equal to K1 on {SHAPE}", flush=True)
    inputs = [normalized_input(x, cfg)] + list(blurs[:-1])
    taps = [_taps(s, x.device) for s in (pre,) + incs]
    err = max(float((conv.separable_blur(i, t) - separable_blur_ref(i, t)).abs().max())
              for i, t in zip(inputs, taps))
    assert err <= 1e-3, f"K9 differs from its plain version by {err}"
    h, w = SHAPE
    # one row for the five launches of a frame, as K1's row times its ladder
    rec.record("separable_blur", "sift_pyocl_tpu_torch/csrc/ladder.cu",
               f"{ROOT}/ops/pallas/conv.py:70", err,
               lambda: [conv.separable_blur(i, t) for i, t in zip(inputs, taps)],
               lambda: [separable_blur_ref(i, t) for i, t in zip(inputs, taps)], 20,
               n_bytes=4 * h * w * 2 * len(taps),
               ops=2 * 2 * sum(t.numel() for t in taps) * h * w,
               library=_conv_calls([inputs], [taps]), wrapper_calls=len(taps))


def check_scales2(img, x, dev) -> dict:
    """P4: SiftPlan.keypoints with SiftConfig(scales=2), against its plain
    run."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    cfg = SiftConfig(scales=2)
    kp, frame_ms, launches, _ = plan_frames("P4", SiftPlan(SHAPE, config=cfg, device=dev), img)
    print(f"P4 (scales=2) CUDA launches over {FRAMES} replayed frames:", launches, flush=True)
    counts = check_wrapper_launches("P4", launches, {"separable_blur": 5 * FRAMES,
                                                     **{n: FRAMES for n in VO_KERNELS[1:6]}})
    ref = to_keypoint_records(detect_and_describe(x, cfg, plain=True))
    hits, l1 = match_keypoint_sets(ref, kp)
    print(f"P4: {len(kp)} keypoints, plain path {len(ref)}, matched {hits}, desc L1 {l1:.4f}; "
          f"ms/frame {[round(m, 3) for m in frame_ms]} (mean {np.mean(frame_ms):.3f})",
          flush=True)
    assert len(kp) >= MIN_KEYPOINTS
    assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
    assert hits >= 0.98 * len(ref) and l1 < 0.1
    return counts


def _by_keypoint(okps, desc, cap: int, max_ori: int, dense: bool):
    """(ok, angle, u8 desc) as (cap, max_ori[, 128]), keypoint i's o-th
    orientation at [i, o]: dense slots are cap*o + i, fused ones
    i*max_ori + o."""
    if dense:
        return (okps.valid.view(max_ori, cap).T, okps.angle.view(max_ori, cap).T,
                desc.view(max_ori, cap, 128).transpose(0, 1))
    return okps.valid.view(cap, max_ori), okps.angle.view(cap, max_ori), desc.view(cap, max_ori, 128)


def _compare_oriented(tag: str, a, b) -> int:
    """Keypoint-wise comparison of two (ok, angle, desc) triples: returns the
    slots whose ok flags differ (printed one by one); where both are ok,
    angles within 1e-4 and u8 descriptors within 1 count, mean < 0.05."""
    ok_a, ang_a, d_a = a
    ok_b, ang_b, d_b = b
    flips = torch.nonzero(ok_a != ok_b).tolist()
    for i, o in flips:
        print(f"  {tag}: keypoint {i} orientation {o}: ok {bool(ok_a[i, o])} / "
              f"{bool(ok_b[i, o])}, angles {float(ang_a[i, o]):.6f} / {float(ang_b[i, o]):.6f}",
              flush=True)
    both = ok_a & ok_b
    if not bool(both.any()):
        return len(flips)
    da = (ang_a[both] - ang_b[both]).abs()
    err_a = float(torch.minimum(da, 2 * np.pi - da).max())
    dq = (d_a[both].int() - d_b[both].int()).abs()
    assert err_a <= 1e-4, f"{tag}: angles {err_a} apart"
    assert int(dq.max()) <= 1 and float(dq.float().mean()) < 0.05, \
        f"{tag}: u8 descriptors {int(dq.max())} apart, mean {float(dq.float().mean())}"
    return len(flips)


def check_split_windows(x: torch.Tensor, rec: Kernels) -> dict:
    """P5: per octave of the 1080x1920 frame under SiftConfig(), detection
    (K10a, K10b), the plain gradient planes padded by pad_grad_planes,
    assign_orientations_pallas (K11a) and compute_descriptors_pallas
    (K11b); held against K6 (orient_desc_fused on the octave's planes) and
    against the plain versions on the same keypoints, and K11b at K6's
    angles and slots to K6's raw descriptors bit for bit.  Prints the
    sample iterations a slot, each wrapper's CUDA launches and ms a call
    with the slot arrays and sigma made outside the timed closure."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    from sift_pyocl_tpu_torch.ops import orient_desc as od
    from sift_pyocl_tpu_torch.ops.detect import detect_octave_pallas
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, window
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space

    cfg = SiftConfig()
    m = cfg.max_ori
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    octaves = build_scale_space(x, cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    per = []
    for o, (blurs, dogs) in enumerate(octaves):
        kps, _ = detect_octave_pallas(dogs, cfg, o, caps[o])
        mags, oris = od.gradient_planes(blurs, cfg)
        mag_p, ori_p = od.pad_grad_planes(mags, oris)
        okps = od.assign_orientations_pallas(mag_p, ori_p, kps, cfg, max_ori=m)
        desc = od.compute_descriptors_pallas(mag_p, ori_p, okps, cfg)
        per.append((kps, mags, oris, mag_p, ori_p, okps, desc))
    torch.cuda.synchronize()
    counts = launch_counts()
    print("P5 (split entry points) launch counts over one frame:", counts, flush=True)
    for name, n in counts.items():
        want = len(octaves) if name in ("compact_mask", "refine_octave", "orientation_hist",
                                        "descriptor_hist") else 0
        assert n == want, f"P5: {name} launched {n} times (want {want})"

    def rep(t):
        return torch.repeat_interleave(t, m, dim=0)

    win_o, win_d = od._ori_window_size(cfg), od._desc_window_size(cfg)
    flips_k6 = flips_plain = 0
    err_h = err_d = 0.0
    n_kv = n_ok = n_slots = n_dslots = n_k6 = 0
    n_circle = n_square = 0
    it_o = it_d = 0
    for o, (kps, mags, oris, mag_p, ori_p, okps, desc) in enumerate(per):
        cap = caps[o]
        sig = od._sigma(cfg, kps.fs)
        hist = window.orientation_hist(mag_p, ori_p, kps.s_int, kps.fr, kps.fc, sig, kps.valid, win_o)
        hist_p = window.orientation_hist_ref(mag_p, ori_p, kps.s_int, kps.fr, kps.fc, sig,
                                             kps.valid, win_o)
        # K11a: bins within 1e-3 of the largest one (sums in other orders),
        # invalid slots exactly 0
        e = float((hist - hist_p).abs().max())
        assert e <= 1e-3 * max(1.0, float(hist_p.abs().max())), f"octave {o}: K11a differs by {e}"
        assert not bool(hist[~kps.valid].any()), f"octave {o}: K11a filled an invalid slot"
        err_h = max(err_h, e)
        okps_p = od.orientation_peaks_dense(hist_p, kps, cfg, m)
        osig = od._sigma(cfg, okps.fs)
        raw = window.descriptor_hist(mag_p, ori_p, okps.s_int, okps.fr, okps.fc, osig,
                                     okps.angle, okps.valid, win_d)
        raw_p = window.descriptor_hist_ref(mag_p, ori_p, okps.s_int, okps.fr, okps.fc, osig,
                                           okps.angle, okps.valid, win_d)
        # K11b: unit descriptors within 1e-5, invalid slots exactly 0
        unit = raw / raw.norm(dim=1, keepdim=True).clamp(min=1e-30)
        unit_p = raw_p / raw_p.norm(dim=1, keepdim=True).clamp(min=1e-30)
        e = float((unit - unit_p).abs().max())
        assert e <= 1e-5, f"octave {o}: K11b unit descriptors differ by {e}"
        assert not bool(raw[~okps.valid].any()), f"octave {o}: K11b filled an invalid slot"
        err_d = max(err_d, e)
        H, W = mags.shape[1], mags.shape[2]
        n_circle += window_samples(kps.fr, kps.fc, sig, kps.valid, win_o, H, W)[0]
        n_square += window_samples(okps.fr, okps.fc, osig, okps.valid, win_d, H, W,
                                   angles=okps.angle[:, None], ok=okps.valid[:, None])[1]
        # sample iterations: the boxes K11a / K11b walk, against the static
        # window's win^2 a slot of the static-window design
        kv, dv = kps.valid, okps.valid
        it_o += int(window.box_samples(window.support_boxes(
            kps.fr[kv], kps.fc[kv], sig[kv], win_o, H, W)).sum())
        it_d += int(window.box_samples(window.support_boxes(
            okps.fr[dv], okps.fc[dv], osig[dv], win_d, H, W, angle=okps.angle[dv])).sum())
        # K6 on the octave's planes; K11b at its angles and slots gives its
        # raw descriptors bit for bit (the same window, boxes and sums)
        ang6, ok6, raw6 = window.orient_desc_fused(
            mags, oris, kps.s_int, kps.fr, kps.fc, sig, kps.valid, win_d, m,
            *window.slot_octave_geometry([cap], [0], [mags]))
        at_k6 = window.descriptor_hist(mag_p, ori_p, rep(kps.s_int), rep(kps.fr), rep(kps.fc),
                                       rep(sig), ang6.reshape(-1), ok6.reshape(-1), win_d)
        assert torch.equal(at_k6, raw6.reshape(-1, 128)), \
            f"octave {o}: K11b at K6's angles differs from K6's raw descriptors"
        n_k6 += int(ok6.sum())
        split = _by_keypoint(okps, desc, cap, m, dense=True)
        fused = (ok6, ang6, od.quantize_descriptors(raw6.reshape(-1, 128)).view(cap, m, 128))
        plain = _by_keypoint(okps_p, od.quantize_descriptors(raw_p), cap, m, dense=True)
        # the ok flags come from the orientations alone: K11a's against K6's
        flips_k6 += _compare_oriented(f"octave {o}, K11a/K11b vs K6", split, fused)
        flips_plain += _compare_oriented(f"octave {o}, K11a/K11b vs plain", split, plain)
        n_kv += int(kps.valid.sum())
        n_ok += int(okps.valid.sum())
        n_slots += cap
        n_dslots += okps.valid.numel()
    print(f"P5: {n_kv} keypoints, {n_ok} oriented slots; ok flags differing from K6 "
          f"(K11a against K6) {flips_k6}, from the plain versions {flips_plain}; hist err "
          f"{err_h:.3g}, unit descriptor err {err_d:.3g}; K11b at K6's angles equals K6's "
          f"raw descriptors bit for bit on all {len(per)} octaves ({n_k6} slots)", flush=True)
    assert n_ok >= MIN_KEYPOINTS and flips_k6 <= 2 and flips_plain <= 2

    def each_octave(fn):
        return lambda: [fn(*p) for p in per]

    def ori_args(kps, mags, oris, mag_p, ori_p, okps, desc):
        return (mag_p, ori_p, kps.s_int, kps.fr, kps.fc, od._sigma(cfg, kps.fs), kps.valid,
                win_o)

    def desc_args(kps, mags, oris, mag_p, ori_p, okps, desc):
        return (mag_p, ori_p, okps.s_int, okps.fr, okps.fc, od._sigma(cfg, okps.fs),
                okps.angle, okps.valid, win_d)

    # least work: each valid slot reads the (mag, ori) samples of its
    # orientation circle (K11a) or rotated descriptor square (K11b) inside
    # its octave once (window_samples, this run's keypoints), about 10
    # operations a sample for a histogram and 20 for a descriptor; per slot
    # its inputs and its f32 output row.  The timed closures make sigma
    # (od._sigma) in each call, as the rows of the static-window design did.
    rows = {
        "orientation_hist": rec.record(
            "orientation_hist", "sift_pyocl_tpu_torch/csrc/window.cu",
            f"{ROOT}/ops/pallas/window.py:193", err_h,
            each_octave(lambda *p: window.orientation_hist(*ori_args(*p))),
            each_octave(lambda *p: window.orientation_hist_ref(*ori_args(*p))), 20,
            n_bytes=n_slots * (17 + 36 * 4) + n_circle * 8, ops=n_circle * 10,
            wrapper_calls=len(per)),
        "descriptor_hist": rec.record(
            "descriptor_hist", "sift_pyocl_tpu_torch/csrc/window.cu",
            f"{ROOT}/ops/pallas/window.py:321", err_d,
            each_octave(lambda *p: window.descriptor_hist(*desc_args(*p))),
            each_octave(lambda *p: window.descriptor_hist_ref(*desc_args(*p))), 20,
            n_bytes=n_dslots * (21 + 128 * 4) + n_square * 8, ops=n_square * 20,
            wrapper_calls=len(per))}
    print(f"P5: window samples read: K11a {n_circle} ({n_circle / max(1, n_kv):.0f} a keypoint "
          f"of {win_o}^2), K11b {n_square} ({n_square / max(1, n_ok):.0f} a slot of {win_d}^2)",
          flush=True)
    rows["orientation_hist"]["k6_flips"] = flips_k6
    iters = {"orientation_hist": (win_o * win_o, it_o / max(1, n_kv)),
             "descriptor_hist": (win_d * win_d, it_d / max(1, n_ok))}
    pre = {"orientation_hist": [ori_args(*p) for p in per],
           "descriptor_hist": [desc_args(*p) for p in per]}
    for name, row in rows.items():
        fn = getattr(window, name)
        before, after = iters[name]
        row["sample_iterations_per_slot"] = [float(before), float(after)]
        # the wrapper alone: slot arrays and sigma made outside the closure
        call = lambda: [fn(*a) for a in pre[name]]
        launches = profile_calls(call, len(per))[0]
        row["prepared_ms"] = cuda_ms(call, 20)
        row["prepared_cuda_launches"] = launches
        assert launches == 1, f"P5: {name} made {launches:g} CUDA launches a call"
        kern_ms = row["kernel_device_ms"] = device_ms(call, f"{name}_kernel")
        print(f"{name}: sample iterations a slot {before:.0f} (static {int(before ** 0.5)}^2 "
              f"window) -> {after:.0f} (support boxes), {before / after:.2f}x fewer; a frame's "
              f"{len(per)} calls: kernel {row['ms']:.4f} ms, {row['cuda_launches']:g} CUDA "
              f"launches a call with sigma made in the closure; {row['prepared_ms']:.4f} ms, "
              f"{launches:g} a call with the slot arrays made before it; device time of its "
              f"{len(per)} kernels {kern_ms:.4f} ms a frame (torch.profiler)", flush=True)
    return counts


def check_plain_keypoints(img, dev) -> None:
    """P6: SiftPlan.keypoints with kp_backend="xla" (plain PyTorch after the
    K1/K2 pyramid), against the kernel path on the same frame."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    kp, frame_ms, launches, _ = plan_frames(
        "P6", SiftPlan(SHAPE, config=SiftConfig(kp_backend="xla"), device=dev), img, frames=1)
    print("P6 (kp_backend='xla') CUDA launches over one replayed frame:", launches, flush=True)
    check_wrapper_launches("P6", launches, {"octave0_ladder": 1, "small_octaves_ladder": 1})
    ref = SiftPlan(SHAPE, config=SiftConfig(), device=dev).keypoints(img)
    hits, l1 = match_keypoint_sets(ref, kp)
    print(f"P6: {len(kp)} keypoints, kernel path {len(ref)}, matched {hits}, desc L1 {l1:.4f}; "
          f"ms/frame {[round(t, 3) for t in frame_ms]}", flush=True)
    assert len(kp) >= MIN_KEYPOINTS
    assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
    assert hits >= 0.98 * len(ref) and l1 < 0.1


def near_decision(dogs: torch.Tensor, peak: float, eth: float, bd: int,
                  tol: float) -> torch.Tensor:
    """Per element of the stencil's (S-2, H-2bd, W-2bd) mask on `dogs`,
    whether moving every DoG value by at most `tol` can flip its outcome:
    the element passes under some such move but not under every one.  A
    neighbour compare moves by at most 2 tol, |v| by tol, hxx and hyy by
    4 tol, hxy by tol; det and eth tr^2 are bounded by interval products
    (a superset of the flips)."""
    S, H, W = dogs.shape

    def at(ds, dr, dc):
        return dogs[1 + ds:S - 1 + ds, bd + dr:H - bd + dr, bd + dc:W - bd + dc]

    def mul(a, b):
        p = torch.stack([a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]])
        return p.amin(0), p.amax(0)

    v = at(0, 0, 0)
    strong = v.abs() - 0.8 * peak
    max_sure = max_can = min_sure = min_can = torch.ones_like(v, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds or dr or dc:
                    g = v - at(ds, dr, dc)
                    max_sure, max_can = max_sure & (g > 2 * tol), max_can & (g > -2 * tol)
                    min_sure, min_can = min_sure & (g < -2 * tol), min_can & (g < 2 * tol)
    hxx = at(0, 0, -1) + at(0, 0, 1) - 2 * v
    hyy = at(0, -1, 0) + at(0, 1, 0) - 2 * v
    hxy = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    hxx_i, hyy_i = (hxx - 4 * tol, hxx + 4 * tol), (hyy - 4 * tol, hyy + 4 * tol)
    hxy_i = (hxy - tol, hxy + tol)
    a, b = mul(hxx_i, hyy_i), mul(hxy_i, hxy_i)
    det = (a[0] - b[1], a[1] - b[0])
    tr = (hxx_i[0] + hyy_i[0], hxx_i[1] + hyy_i[1])
    t = mul(tr, tr)
    edge = (det[0] - eth * t[1], det[1] - eth * t[0])
    sure = (strong > tol) & (max_sure | min_sure) & (det[0] > 0) & (edge[0] >= 0)
    can = (strong > -tol) & (max_can | min_can) & (det[1] > 0) & (edge[1] >= 0)
    return can & ~sure


def check_fused_masks(x: torch.Tensor, rec: Kernels) -> None:
    """K1m and K2m (the mask forms of K1/K2, SiftConfig(mask_backend=
    "fused")) on the main path's frame: blurs and DoGs bit-equal to K1's and
    K2's, every octave's mask bit-equal to K8's and to the plain stencil on
    those DoGs; against their plain versions (plain ladder + stencil) the
    stacks within check_ladders' 1e-3 and the masks equal except at pixels
    whose plain test lies within that of a decision (counted); times beside
    K1 + K8, K2 + K8 and the plain versions."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.kernels import ladder, maskk
    from sift_pyocl_tpu_torch.ops.pyramid import (_taps, downsample_octave, normalized_input,
                                                  pre_blur_sigma)

    cfg = SiftConfig(mask_backend="fused")
    bd, peak = cfg.border_dist, cfg.peak_thresh
    data = normalized_input(x, cfg)
    pre, incs = pre_blur_sigma(cfg), cfg.sigma_increments()
    n_oct = cfg.n_octaves(SHAPE)
    mc0 = (peak, maskk.octave_edge_thresh(cfg, 0), bd)
    eths = tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct))
    mc = (peak, eths, bd)
    b0, d0 = ladder.octave0_ladder(data, pre, incs)
    mb0, md0, m0 = ladder.octave0_ladder_mask(data, pre, incs, mc0)
    base = downsample_octave(b0[cfg.scales], cfg.downsample_mode)
    args2 = (base, incs, n_oct - 1, cfg.scales, cfg.downsample_mode)
    small = ladder.small_octaves_ladder(*args2)
    msmall = ladder.small_octaves_ladder_mask(*args2, mc)
    torch.cuda.synchronize()
    assert torch.equal(b0, mb0) and torch.equal(d0, md0), "K1m's stacks differ from K1's"
    for o, ((b, d), (mb, md, _)) in enumerate(zip(small, msmall)):
        assert torch.equal(b, mb) and torch.equal(d, md), f"K2m's octave {o + 1} differs from K2's"
    dogs = [d0] + [d for _, d in small]
    masks = [m0] + [m for _, _, m in msmall]
    k8 = maskk.extrema_masks(dogs, cfg)
    stencil = maskk.extrema_masks_ref(dogs, cfg)
    torch.cuda.synchronize()
    for o, (m, k, st) in enumerate(zip(masks, k8, stencil)):
        assert m.dtype == torch.bool and torch.equal(m, k) and torch.equal(m, st), \
            f"octave {o}: the in-ladder mask differs from K8 / the stencil"
    n_cand = [int(m.sum()) for m in masks]
    print(f"K1m/K2m: stacks bit-equal to K1/K2, masks bit-equal to K8 and the stencil on all "
          f"{len(masks)} octaves, candidates {n_cand}", flush=True)

    # against the plain versions on the same inputs
    tol = 1e-3
    rb0, rd0, rm0 = ladder.octave0_ladder_mask_ref(data, pre, incs, mc0)
    rsmall = ladder.small_octaves_ladder_mask_ref(*args2, mc)
    torch.cuda.synchronize()
    err1m = max(float((mb0 - rb0).abs().max()), float((md0 - rd0).abs().max()))
    err2m = max(max(float((b - rb).abs().max()), float((d - rd).abs().max()))
                for (b, d, _), (rb, rd, _) in zip(msmall, rsmall))
    assert err1m <= tol and err2m <= tol, f"vs plain: K1m {err1m}, K2m {err2m}"
    n_diff, n_near = [], []
    for o, (m, (_, rd, rm), eth) in enumerate(zip(masks, [(rb0, rd0, rm0)] + rsmall,
                                                 (mc0[1],) + eths)):
        differ = m != rm
        near = near_decision(rd, peak, eth, bd, tol)
        assert not (differ & ~near).any(), \
            f"octave {o}: {int((differ & ~near).sum())} mask pixels differ from the plain " \
            f"version away from every decision"
        n_diff.append(int(differ.sum()))
        n_near.append(int(near.sum()))
    print(f"K1m/K2m vs plain (plain ladder + stencil): stacks max_abs_err K1m {err1m:.3g}, "
          f"K2m {err2m:.3g} (limit {tol}); mask pixels that differ per octave {n_diff}, all "
          f"within {tol} of a decision (such pixels per octave {n_near})", flush=True)

    def k1_k8():
        maskk.extrema_masks([ladder.octave0_ladder(data, pre, incs)[1]], cfg)

    def k2_k8():
        # K8 takes an octave's edge threshold by its index in the list, so
        # the first small octave is tested here at octave 0's threshold: the
        # same work, another threshold
        maskk.extrema_masks([d for _, d in ladder.small_octaves_ladder(*args2)], cfg)

    ms_k1_k8, ms_k2_k8 = cuda_ms(k1_k8, 20), cuda_ms(k2_k8, 20)
    (n_k1_k8, dev_k1_k8), (n_k2_k8, dev_k2_k8) = profile_calls(k1_k8), profile_calls(k2_k8)
    # device ms a launch of each one-launch kernel, which a lost profiler
    # record does not lower: K2m, and K2 and K8 on the same small octaves
    per_launch = {"K2m": kernel_launch_ms(lambda: ladder.small_octaves_ladder_mask(*args2, mc),
                                          "small_octaves_kernel_masks"),
                  "K2": kernel_launch_ms(k2_k8, "small_octaves_kernel"),
                  "K8 on octaves 1-6": kernel_launch_ms(k2_k8, "mask_kernel"),
                  "K8 on octave 0": kernel_launch_ms(k1_k8, "mask_kernel")}
    print("device ms a launch (recorded launches a call): " + ", ".join(
        f"{k} {ms:.4f} ({n:g})" for k, (n, ms) in per_launch.items()), flush=True)

    h, w = SHAPE
    n_lv = len(incs)
    all_taps = [_taps(float(s), x.device) for s in (pre,) + incs]
    # K1's and K2's bytes and operations, plus each mask byte written once
    # and about 70 operations a mask element (as K8's row)
    rec.record("octave0_ladder_mask", "sift_pyocl_tpu_torch/csrc/ladder.cu",
               f"{ROOT}/ops/pallas/ladder0.py:256", err1m,
               lambda: ladder.octave0_ladder_mask(data, pre, incs, mc0),
               lambda: ladder.octave0_ladder_mask_ref(data, pre, incs, mc0), 20,
               n_bytes=4 * h * w * (1 + (n_lv + 1) + n_lv) + m0.numel(),
               ops=2 * 2 * sum(t.numel() for t in all_taps) * h * w + 70 * m0.numel())
    px = sum(b.shape[1] * b.shape[2] for b, _ in small)
    mask_px = sum(m.numel() for m in masks[1:])
    rec.record("small_octaves_ladder_mask", "sift_pyocl_tpu_torch/csrc/ladder.cu",
               f"{ROOT}/ops/pallas/ladder.py:421", err2m,
               lambda: ladder.small_octaves_ladder_mask(*args2, mc),
               lambda: ladder.small_octaves_ladder_mask_ref(*args2, mc), 20,
               n_bytes=4 * (base.numel() + px * (2 * n_lv + 1)) + mask_px,
               ops=2 * 2 * sum(t.numel() for t in all_taps[1:]) * px + 70 * mask_px)
    k1m, k2m = rec.rows["octave0_ladder_mask"], rec.rows["small_octaves_ladder_mask"]
    table, blocks = ladder._small_plan(tuple(ladder._geometry(*base.shape, n_oct - 1)),
                                       tuple(map(float, incs)), cfg.scales, x.device, bd)[:2]
    print(f"K1m {k1m['ms']:.4f} ms (device {k1m['device_ms']:.4f}, CUDA launches a call "
          f"{k1m['cuda_launches']:g}) beside K1 + K8 on octave 0 {ms_k1_k8:.4f} ms (device "
          f"{dev_k1_k8:.4f}, {n_k1_k8:g}); K2m {k2m['ms']:.4f} ms (device {k2m['device_ms']:.4f}, "
          f"{k2m['cuda_launches']:g}; {int(table[0])} steps on {blocks} blocks) beside K2 + K8 on "
          f"octaves 1-{n_oct - 1} {ms_k2_k8:.4f} ms (device {dev_k2_k8:.4f}, {n_k2_k8:g})",
          flush=True)
    k1m["unfused"] = {"ms": ms_k1_k8, "device_ms": dev_k1_k8, "cuda_launches": n_k1_k8,
                      "k8_device_ms_per_launch": per_launch["K8 on octave 0"][1]}
    k2m["unfused"] = {"ms": ms_k2_k8, "device_ms": dev_k2_k8, "cuda_launches": n_k2_k8,
                      "k2_device_ms_per_launch": per_launch["K2"][1],
                      "k8_device_ms_per_launch": per_launch["K8 on octaves 1-6"][1]}
    k2m["device_ms_per_launch"] = per_launch["K2m"][1]
    # a lost profiler record only lowers a count
    assert 0 < k2m["cuda_launches"] <= 1, f"K2m made {k2m['cuda_launches']} CUDA launches a call"
    assert 0 < k1m["cuda_launches"] <= 7, f"K1m made {k1m['cuda_launches']} CUDA launches a call"


def check_vo_fused(base: dict, p1: dict) -> dict:
    """P7: the main path with SiftConfig(mask_backend="fused"), against the
    default mask's run of check_vo on the same frames, beside P1; the plain
    stencil never called (eager steps, the graph's warm-up and capture)."""
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig
    from sift_pyocl_tpu_torch.ops.kernels.maskk import stencil_mask

    cfg, vo = SiftConfig(mask_backend="fused"), VOConfig()
    imgs, K = base["imgs"], base["K"]
    stencil_mask.calls = 0
    run = drive_vo_path("P7", cfg, vo, imgs, K, STEP_LAUNCHES_FUSED, base["decode_launches"],
                        {"ladders": FUSED_LADDERS})
    print(f"P7: plain stencil calls (vo_init and the steps): {stencil_mask.calls}", flush=True)
    assert stencil_mask.calls == 0, \
        f"the plain stencil ran {stencil_mask.calls} times on the fused path"
    check_vo_against_base("P7", run, base)
    mask_turns((("default", SiftConfig()), ("fused", cfg), ("fused", cfg),
                ("default", SiftConfig())), imgs, K, vo)
    print_vo_paths((("default mask", base), ("K8 mask (P1)", p1), ("fused mask (P7)", run)))
    return run


def check_fused_scales2(img, x, dev) -> None:
    """SiftPlan.keypoints with SiftConfig(mask_backend="fused", scales=2):
    octave 0 through K9 and the plain stencil (its fused mask entry is
    None), octaves >= 1 through K2m; its buffer equal to scales=2 without
    fusion, its keypoints held to its plain=True run."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.ops.kernels.maskk import stencil_mask
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    cfg = SiftConfig(mask_backend="fused", scales=2)
    plan = SiftPlan(SHAPE, config=cfg, device=dev)
    kp, frame_ms, launches, _ = plan_frames("fused scales=2", plan, img)
    stencil_mask.calls = 0
    plan._fn(torch.from_numpy(img).to(dev))
    stencil_calls = stencil_mask.calls
    print(f"fused scales=2 CUDA launches over {FRAMES} replayed frames:", launches,
          f"plain stencil calls in an eager frame: {stencil_calls}", flush=True)
    check_wrapper_launches("fused scales=2", launches, {
        "separable_blur": 5 * FRAMES, "small_octaves_ladder_mask": FRAMES,
        **{n: FRAMES for n in VO_KERNELS[2:6]}})
    assert stencil_calls == 1, f"the stencil ran {stencil_calls} times for octave 0"
    got = plan.keypoints_raw(img)
    want = SiftPlan(SHAPE, config=SiftConfig(scales=2), device=dev).keypoints_raw(img)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"fused scales=2: {f} differs"
    ref = to_keypoint_records(detect_and_describe(x, cfg, plain=True))
    hits, l1 = match_keypoint_sets(ref, kp)
    print(f"fused scales=2: {len(kp)} keypoints, buffer equal to scales=2 unfused; plain path "
          f"{len(ref)}, matched {hits}, desc L1 {l1:.4f}; ms/frame "
          f"{[round(m, 3) for m in frame_ms]}", flush=True)
    assert len(kp) >= MIN_KEYPOINTS
    assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
    assert hits >= 0.98 * len(ref) and l1 < 0.1


# K7f tolerance: |d - d_plain| <= F32_RTOL * (|a|^2 + max_j |b_j|^2), the
# magnitude the distance is computed from: the kernel sums each dot product
# over k = 0..127 in order, the plain version's matmul in blocks, each
# within about 128 f32 roundings of 6e-8 of that magnitude.
F32_RTOL = 1e-5


def check_matcher_f32(bufs, rec: Kernels) -> dict:
    """P8: K7f (f32 operands) through match_descriptors_dense at the VO map
    call's shapes: frame 1's 8320 keypoint slots against a 2048-slot map
    of frame 0 (its valid keypoints first, then invalid slots; no slot
    twice, so ties are real ones), both as f32.  Scaled by 1/512 the sums
    stay exact (every partial sum an integer times 2^-18 below 2^24);
    scaled by 1/255 they round.  Returns the launch counts of the path."""
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, matchk, reset_launch_counts
    from sift_pyocl_tpu_torch.ops.match import match_descriptors_dense

    f0, f1 = bufs[0], bufs[1]
    map_ids = torch.sort((~f0.valid).to(torch.uint8), stable=True).indices[:2048]
    v2 = f0.valid[map_ids].clone()
    v1 = f1.valid
    n_valid = int(v1.sum())
    torch.cuda.synchronize()
    reset_launch_counts()
    for scale in (512.0, 255.0):
        match_descriptors_dense(f1.desc.float() / scale, v1, f0.desc[map_ids].float() / scale, v2)
    torch.cuda.synchronize()
    counts = launch_counts()
    print("P8 (f32 match_descriptors_dense, 2 calls) launch counts:", counts, flush=True)
    for name, n in counts.items():
        assert n == (2 if name == "best2_l2_f32" else 0), f"P8: {name} launched {n} times"
    # at 1/512 every partial sum is exact: K7's bits times 2^-18
    d2u = f0.desc[map_ids].clone()
    got = matchk.best2_l2_f32(f1.desc.float() / 512.0, d2u.float() / 512.0, v2, v1)
    want = matchk.best2_l2(f1.desc, d2u, v2, v1)
    torch.cuda.synchronize()
    for f, g, w in zip(("d1", "d2"), got[:2], want[:2]):
        assert torch.equal(g * 2.0 ** 18, w), \
            f"K7f (1/512) {f} x 2^18 differs from K7 on {int((g * 2.0 ** 18 != w).sum())} rows"
    assert torch.equal(got[2], want[2]), "K7f (1/512) i1 differs from K7"
    print(f"best2_l2_f32 (1/512) x 2^18 equals K7 on the u8 descriptors bit for bit "
          f"({n_valid} valid rows)", flush=True)
    worst = 0.0
    for scale in (512.0, 255.0):
        a, b = f1.desc.float() / scale, f0.desc[map_ids].float() / scale
        got = matchk.best2_l2(a, b, v2, v1)
        again = matchk.best2_l2(a, b, v2, v1)
        want = matchk.best2_l2_ref(a, b, v2)
        torch.cuda.synchronize()
        mag = (a * a).sum(1) + float((b * b).sum(1).max())
        err = max(float(((g - w).abs() / mag)[v1].max()) for g, w in zip(got[:2], want[:2]))
        near = (want[1] - want[0]) <= F32_RTOL * mag
        diff_i = v1 & (got[2] != want[2])
        assert err <= F32_RTOL, f"K7f (1/{scale:g}) d1/d2 differ by {err} of their magnitude"
        assert not bool((diff_i & ~near).any()), f"K7f (1/{scale:g}): i1 differs off a near-tie"
        for g, r in zip(got, again):
            assert torch.equal(g, r), f"K7f (1/{scale:g}) gave other bits on a second call"
        print(f"best2_l2_f32 (1/{scale:g}, {a.shape[0]} x {b.shape[0]}, {n_valid} valid rows): "
              f"d1/d2 within {err:.3g} of their magnitude (limit {F32_RTOL:g}); i1 differs "
              f"on {int(diff_i.sum())} rows, {int((near & v1).sum())} valid rows are near-ties",
              flush=True)
        worst = max(worst, err)
    a, b = f1.desc.float() / 512.0, f0.desc[map_ids].float() / 512.0

    def library():
        torch.topk(torch.mm(a, b.T), 2, dim=1, largest=False)

    # least work: 2 x 128 f32 operations a valid (row, column) pair, at the
    # f32 rate outside the tensor cores (an invalid column is +inf and
    # needs none); each input read once
    row = rec.record("best2_l2_f32", "sift_pyocl_tpu_torch/csrc/matchk.cu",
                     f"{ROOT}/ops/pallas/matchk.py:113", worst,
                     lambda: matchk.best2_l2(a, b, v2, v1),
                     lambda: matchk.best2_l2_ref(a, b, v2), 50,
                     n_bytes=4 * (a.numel() + b.numel()) + v1.numel() + v2.numel()
                     + 12 * a.shape[0], ops=2 * 128 * n_valid * int(v2.sum()),
                     library=library)
    # one launch of the kernel a call and nothing else, by name, from the
    # fullest of five sessions; the device ms is a launch's mean, which a
    # lost record does not lower
    calls = 5
    events = cuda_events(lambda: matchk.best2_l2_f32(a, b, v2, v1), calls)
    named = [e for e in events if "best2_l2_f32_kernel" in e.name]
    assert len(named) == calls and len(events) == calls, \
        f"K7f: {len(named)} kernel, {len(events) - len(named)} other launches in {calls} calls"
    row["cuda_launches"] = len(named) / calls
    row["device_ms"] = sum(e.device_time_total for e in named) / 1e3 / len(named)
    print(f"best2_l2_f32: 1 CUDA launch a call (best2_l2_f32_kernel), device "
          f"{row['device_ms']:.4f} ms a launch", flush=True)
    return counts


# K12 and K13 (csrc/linalg.cu): no Pallas kernel stands behind them; they
# are what jnp.linalg.eigh and jnp.linalg.svd are inside the JAX package's
# jitted two-view init.  Their operations depend on the data (the rotations
# a matrix needs), so the bound counts this run's rotations with a float32
# replica of each kernel's loop (jacobi_ops, svd3_ops): per eigen rotation
# the angle (14 operations), the two rows (6 a column of n - 2), the
# diagonal (4) and V (6 n); 7 a pair tested; per one-sided rotation of the
# SVD the angle (14) and two columns of A and V (36), 20 a pair tested
# (three dot products), and 60 for the norms and U at the end.
LINALG_EPS = np.float32(1.1920929e-7)


def _rotation(app, aqq, apq):
    """(c, s, t) of csrc/linalg.cu's jacobi_rotation, in float32, where
    the rotation is made (apq != 0 there)."""
    with np.errstate(all="ignore"):
        theta = (aqq - app) / (np.float32(2) * apq)
        t = np.float32(1) / (np.abs(theta) + np.sqrt(theta * theta + np.float32(1)))
        t = np.where(theta < 0, -t, t).astype(np.float32)
        c = (np.float32(1) / np.sqrt(t * t + np.float32(1))).astype(np.float32)
    return c, (t * c).astype(np.float32), t


def jacobi_ops(A: np.ndarray) -> int:
    """K12's operations on A (B, n, n) float32: its loop (cyclic sweeps, a
    rotation where |a_pq| > eps sqrt|a_pp| sqrt|a_qq|, a matrix done after a
    sweep with none) run on every matrix at once in float32."""
    a = A.astype(np.float32).copy()
    B, n = a.shape[0], a.shape[-1]
    active = np.ones(B, bool)
    rotations = tests = 0
    for _ in range(16):
        rotated = np.zeros(B, bool)
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
                go = active & (np.abs(apq) > LINALG_EPS * np.sqrt(np.abs(app))
                               * np.sqrt(np.abs(aqq)))
                tests += int(active.sum())
                if not go.any():
                    continue
                rotations += int(go.sum())
                rotated |= go
                c, s_, t = _rotation(app[go], aqq[go], apq[go])
                sub = a[go]
                cp, cq = sub[:, :, p].copy(), sub[:, :, q].copy()
                sub[:, :, p] = c[:, None] * cp - s_[:, None] * cq
                sub[:, :, q] = s_[:, None] * cp + c[:, None] * cq
                sub[:, p, :], sub[:, q, :] = sub[:, :, p], sub[:, :, q]
                sub[:, p, p] = app[go] - t * apq[go]
                sub[:, q, q] = aqq[go] + t * apq[go]
                sub[:, p, q] = sub[:, q, p] = 0
                a[go] = sub
        active &= rotated
        if not active.any():
            break
    return rotations * (14 + 6 * (n - 2) + 4 + 6 * n) + 7 * tests


def svd3_ops(A: np.ndarray) -> int:
    """K13's operations on A (B, 3, 3) float32: its one-sided sweeps over
    the column pairs (0, 1), (0, 2), (1, 2) run on every matrix at once in
    float32, and the norms and U at the end."""
    a = A.astype(np.float32).copy()
    B = a.shape[0]
    active = np.ones(B, bool)
    rotations = tests = 0
    for _ in range(12):
        rotated = np.zeros(B, bool)
        for p, q in ((0, 1), (0, 2), (1, 2)):
            x, y = a[:, :, p], a[:, :, q]
            al, be, ga = ((u * v).sum(1, dtype=np.float32) for u, v in ((x, x), (y, y), (x, y)))
            go = active & (np.abs(ga) > LINALG_EPS * np.sqrt(al) * np.sqrt(be))
            tests += int(active.sum())
            if not go.any():
                continue
            rotations += int(go.sum())
            rotated |= go
            c, s_, _ = _rotation(al[go], be[go], ga[go])
            xp, yq = x[go].copy(), y[go].copy()
            a[go, :, p] = c[:, None] * xp - s_[:, None] * yq
            a[go, :, q] = s_[:, None] * xp + c[:, None] * yq
        active &= rotated
        if not active.any():
            break
    return rotations * 50 + 20 * tests + 60 * B


def linalg_scene(dev):
    """A two-view scene as the bootstrap meets it: 150 matches (45 of them
    outliers) of 150 points seen from two poses at K = (400, 160, 120),
    K-normalized, padded to their 256-row bucket; 256 eight-point rows
    drawn as the init draws them and the true inliers' row.  Returns the
    (257, 9, 9) A^T A and the true inlier mask."""
    import importlib

    from sift_pyocl_tpu_torch.sfm import geometry as tg

    tr = importlib.import_module("sift_pyocl_tpu_torch.sfm.ransac")
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.uniform([-2, -2, 4], [2, 2, 9], (150, 3)))
    K = torch.tensor([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1.0]], dtype=torch.float64)
    R = tg.so3_exp(torch.tensor([0.03, -0.25, 0.02], dtype=torch.float64))
    t = torch.tensor([-0.8, 0.1, 0.05], dtype=torch.float64)
    uv1 = tg.project(K, torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64),
                     X)[0].numpy()
    uv2 = tg.project(K, R, t, X)[0].numpy() + rng.normal(0, 0.3, (150, 2))
    out = rng.choice(150, 45, replace=False)
    uv2[out] = rng.uniform(0, 300, (45, 2))
    gt_in = np.ones(256, bool)
    gt_in[out] = False
    gt_in[150:] = False
    xy = [tg.backproject(K.float(), torch.from_numpy(
        np.concatenate([u, np.zeros((106, 2))]).astype(np.float32)))[:, :2] for u in (uv1, uv2)]
    valid = torch.arange(256) < 150
    W = torch.cat([torch.from_numpy(gt_in)[None].float(), tr._sample_weights(0, valid, 256, 8)])
    return tg._eight_point_normal(xy[0], xy[1], W)[0].to(dev), gt_in


def check_linalg_kernels(dev, rec: Kernels) -> None:
    """K12 and K13 against their plain versions (torch.linalg.eigh and
    torch.linalg.svd on the card) at the two-view init's shapes: K12 on the
    (257, 9, 9) A^T A of 256 eight-point rows and a refit at the 256-row
    bucket, K13 on the 257 fits' (3, 3) null vectors.  K12: eigenvalues
    within 1e-5 of each matrix's largest entry, V orthonormal, and the least
    eigenvalue's vector, where float64 pins it down, no farther from
    float64's than eigh's plus 1e-4; K13: S within 2e-6 of S[0], U and Vh
    orthonormal, A rebuilt within 4e-6.  One launch a call, the same bits on
    two calls.  The plain version is the library call."""
    from sift_pyocl_tpu_torch.ops.kernels import linalg

    A, _ = linalg_scene(dev)
    w, V = linalg.sym_eig_small(A)
    wp, Vp = linalg.sym_eig_small(A, plain=True)
    w64, V64 = torch.linalg.eigh(A.double())
    scale = A.abs().amax((-1, -2))
    err_w = float(((w - wp).abs().amax(-1) / scale).max())
    ortho = float((V.transpose(-1, -2) @ V - torch.eye(9, device=dev)).abs().max())
    apart = (w64[:, 1] - w64[:, 0]) > 1e-3 * scale

    def null_err(X):
        d = torch.minimum((X[:, :, 0] - V64[:, :, 0]).abs().amax(-1),
                          (X[:, :, 0] + V64[:, :, 0]).abs().amax(-1))
        return float(d[apart].max())

    e_k, e_p = null_err(V.double()), null_err(Vp.double())
    again = linalg.sym_eig_small(A)
    assert torch.equal(again[0], w) and torch.equal(again[1], V), "K12: other bits on a call"
    assert err_w < 1e-5 and ortho < 1e-5, (err_w, ortho)
    assert e_k <= e_p + 1e-4, f"K12's null vector {e_k} from float64, eigh's {e_p}"
    print(f"sym_eig_small (K12, {tuple(A.shape)}): eigenvalues within {err_w:.3g} of |A| of "
          f"eigh's, V orthonormal within {ortho:.3g}; least eigenvalue's vector {e_k:.3g} from "
          f"float64 (eigh {e_p:.3g}) on the {int(apart.sum())} matrices float64 pins down",
          flush=True)
    n = A.shape[0]
    ops = jacobi_ops(A.cpu().numpy())
    row = rec.record("sym_eig_small", "sift_pyocl_tpu_torch/csrc/linalg.cu",
                     f"{ROOT}/sfm/geometry.py:269", float((w - wp).abs().max()),
                     lambda: linalg.sym_eig_small(A), lambda: linalg.sym_eig_small(A, plain=True),
                     50, n_bytes=4 * n * (81 + 9 + 81), ops=ops,
                     library=lambda: torch.linalg.eigh(A))
    assert row["cuda_launches"] == 1, f"K12 made {row['cuda_launches']} CUDA launches a call"
    row["jacobi_ops"] = ops

    F = Vp[:, :, 0].reshape(n, 3, 3).contiguous()
    U, S, Vh = linalg.svd3(F)
    Up, Sp, Vhp = linalg.svd3(F, plain=True)
    err_s = float(((S - Sp).abs() / Sp[:, :1]).max())
    eye = torch.eye(3, device=dev)
    ortho = max(float((M - eye).abs().max())
                for M in (U.transpose(-1, -2) @ U, Vh @ Vh.transpose(-1, -2)))
    rebuilt = float((((U * S[:, None, :]) @ Vh - F).abs().amax((-1, -2)) / Sp[:, 0]).max())
    again = linalg.svd3(F)
    assert all(torch.equal(a, b) for a, b in zip(again, (U, S, Vh))), "K13: other bits on a call"
    assert err_s < 2e-6 and ortho < 2e-6 and rebuilt < 4e-6, (err_s, ortho, rebuilt)
    print(f"svd3 (K13, {tuple(F.shape)}): S within {err_s:.3g} of S[0] of svd's, U and Vh "
          f"orthonormal within {ortho:.3g}, A rebuilt within {rebuilt:.3g}", flush=True)
    ops = svd3_ops(F.cpu().numpy())
    row = rec.record("svd3", "sift_pyocl_tpu_torch/csrc/linalg.cu",
                     f"{ROOT}/sfm/geometry.py:272", float((S - Sp).abs().max()),
                     lambda: linalg.svd3(F), lambda: linalg.svd3(F, plain=True), 50,
                     n_bytes=4 * n * (9 + 9 + 3 + 9), ops=ops,
                     library=lambda: torch.linalg.svd(F))
    assert row["cuda_launches"] == 1, f"K13 made {row['cuda_launches']} CUDA launches a call"
    row["jacobi_ops"] = ops


# The API path (phase A): frames are crops of the VO phases' scene, the
# reference frame the crop at (32, 32); users stabilise 1080p video against
# a reference frame.
API_SCENE = (1144, 1984)
API_ORIGIN = (32, 32)
API_CALLS = 5
FRONTEND = ("octave0_ladder", "small_octaves_ladder", "compact_masks_multi", "refine_multi",
            "grad_atlas", "orient_desc_fused")


def api_crop(base, dy: int = 0, dx: int = 0) -> np.ndarray:
    y, x = API_ORIGIN[0] + dy, API_ORIGIN[1] + dx
    return np.ascontiguousarray(base[y:y + SHAPE[0], x:x + SHAPE[1]])


def counted_align(la, img, **kw):
    """One align call, and the CUDA launches of an align call with the same
    arguments read by kernel name (kernel_counts: the plan's detector
    replays a graph): K1-K6 once, K7 never (the default metric is L1)."""
    out = la.align(img, return_all=True, **kw)
    check_wrapper_launches(f"align({kw})", kernel_counts(lambda: la.align(img, **kw)),
                           {name: 1 for name in FRONTEND})
    assert out is not None, f"align({kw}) found too few matches"
    return out


def check_api_align(dev) -> dict:
    """Phase A: LinearAlign and MatchPlan at 1080x1920 on the card, the
    reference library's API (tests/test_align.py's tolerances): translation,
    a 2 deg / 1.02x affine, shift_only with double_check, relative over 4
    frames, orsa, MatchPlan(metric="L2") on K7 against the CPU's indices,
    K1-K6 once per align call; ms per warm align call and its split."""
    from sift_pyocl_tpu_torch import LinearAlign, MatchPlan, affine_warp, fit_affine
    from sift_pyocl_tpu_torch.models import match_align
    from sift_pyocl_tpu_torch.ops.match import _match_packed_eager, match_packed
    from sift_pyocl_tpu_torch.ops.transform import _affine_warp_eager
    from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

    base = synthetic_scene(API_SCENE, n_blobs=200, seed=0)
    ref = api_crop(base)
    img = api_crop(base, -3, 5)                 # (dy, dx) = (-3, +5)
    want_off = np.array([3.0, -5.0])            # ref -> img: (-dy, -dx)
    interior = (slice(64, -64), slice(64, -64))
    t = time.perf_counter()
    la = LinearAlign(ref, device=dev)
    print(f"LinearAlign{SHAPE} init (kernels built, reference keypoints): "
          f"{1e3 * (time.perf_counter() - t):.1f} ms, {len(la.ref_kp)} reference keypoints",
          flush=True)

    out = counted_align(la, img)
    err = float(np.median(np.abs(out["result"][interior] - ref[interior])))
    print(f"translation: {len(out['matches'])} matches, matrix {out['matrix'].tolist()}, "
          f"offset {out['offset'].tolist()} (want {want_off.tolist()}), interior median "
          f"error {err:.4f}", flush=True)
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(out["offset"], want_off, atol=0.3)
    assert err < 2.0, err

    # a known affine: img(p) = ref(M p + off) about the centre, so the fit
    # (ref -> img) recovers inv(M) and -inv(M) off
    th = math.radians(2.0)
    M = 1.02 * np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    c = (np.array(SHAPE, float) - 1) / 2
    off = c - M @ c
    warped = affine_warp(ref, M, off, device=dev).cpu().numpy()
    aff = counted_align(la, warped)
    Minv = np.linalg.inv(M)
    err_a = float(np.median(np.abs(aff["result"][interior] - ref[interior])))
    print(f"affine (2 deg, 1.02x): {len(aff['matches'])} matches, matrix error "
          f"{np.abs(aff['matrix'] - Minv).max():.3g}, offset error "
          f"{np.abs(aff['offset'] + Minv @ off).max():.3g} px, interior median error "
          f"{err_a:.4f}", flush=True)
    np.testing.assert_allclose(aff["matrix"], Minv, atol=0.02)
    np.testing.assert_allclose(aff["offset"], -Minv @ off, atol=0.3)

    sh = counted_align(la, img, shift_only=True, double_check=True)
    print(f"shift_only + double_check: {len(sh['matches'])} matches, offset "
          f"{sh['offset'].tolist()}", flush=True)
    np.testing.assert_allclose(sh["offset"], want_off, atol=0.3)
    assert len(sh["matches"]) <= len(out["matches"])

    rel = LinearAlign(ref, device=dev)
    rel_off = []
    for k in range(1, 5):                       # 2 px a frame to the right
        o = counted_align(rel, api_crop(base, 0, 2 * k), shift_only=True, relative=True)
        rel_off.append(o["offset"].tolist())
        assert abs(o["offset"][1] + 2.0 * k) < 0.8 and abs(o["offset"][0]) < 0.8, (k, o["offset"])
    print(f"relative over 4 frames: composed offsets {rel_off}", flush=True)

    orsa = counted_align(la, img, orsa=True, seed=0)
    kp = la.sift.keypoints(img)
    m = orsa["matches"]
    p_ref = np.stack([la.ref_kp["y"][m[:, 0]], la.ref_kp["x"][m[:, 0]]], 1)
    p_img = np.stack([kp["y"][m[:, 1]], kp["x"][m[:, 1]]], 1)
    resid = np.sum((p_ref @ np.asarray(orsa["matrix"]).T + orsa["offset"] - p_img) ** 2, 1)
    print(f"orsa: {len(m)} of {len(out['matches'])} matches kept, worst squared residual "
          f"{resid.max():.4f} px^2, offset {orsa['offset'].tolist()}", flush=True)
    assert len(m) >= 4 and np.all(resid < 9.0 + 1e-3)
    np.testing.assert_allclose(orsa["offset"], want_off, atol=0.3)

    # MatchPlan(metric="L2"): K7 once a replayed match_index, the CPU's indices
    l2 = MatchPlan(metric="L2", device=dev)
    idx_l2 = l2.match_index(la.ref_kp, kp)
    check_wrapper_launches("MatchPlan L2 replay", kernel_counts(
        lambda: l2.match_index(la.ref_kp, kp)), {"best2_l2": 1})
    want_l2 = MatchPlan(metric="L2", device="cpu").match_index(la.ref_kp, kp)
    np.testing.assert_array_equal(idx_l2, want_l2)
    want_l1 = MatchPlan(device="cpu").match_index(la.ref_kp, kp)
    np.testing.assert_array_equal(la.match_plan.match_index(la.ref_kp, kp), want_l1)
    print(f"MatchPlan L2: {len(idx_l2)} matches, K7 once a replayed call (by kernel name), "
          f"equal to the CPU's; L1 (default): {len(want_l1)} matches, equal to the CPU's",
          flush=True)

    # the matcher's and the warp's graphs against their eager functions on
    # the same inputs, bit for bit (the align's bucket pair; its fit)
    pads = [la.match_plan._padded(k, np.ones(len(k), bool))[:2] for k in (la.ref_kp, kp)]
    m_args = (*pads[0], *pads[1], dev)
    for metric in ("L1", "L2"):
        got = match_packed(*m_args, metric=metric, ratio_sq=la.match_plan.ratio_th)
        want = _match_packed_eager(*m_args, metric=metric, ratio_sq=la.match_plan.ratio_th)
        assert torch.equal(got, want), f"MatchPlan {metric}: replay differs from eager"
    w_args = (img, out["matrix"], out["offset"])
    assert torch.equal(affine_warp(*w_args, device=dev), _affine_warp_eager(*w_args, device=dev))
    print(f"match_index ({pads[0][0].shape[0]} x {pads[1][0].shape[0]} bucket rows, L1 and "
          f"L2) and the warp: replays bit-equal to eager", flush=True)

    # the plan's replayed buffer against its eager detector's
    check_buffers_equal("align's plan", la.sift.keypoints_raw(img),
                        la.sift._fn(torch.from_numpy(img).to(dev)))
    # ms per warm align call (host image in, host result out) and its
    # split; replayed and eager (the detector, the matcher, the warp) in turns
    counted_align(la, img)
    torch.cuda.synchronize()
    turns = {"eager": [], "replay": []}
    for turn in ("eager", "replay", "replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            la.align(img, return_all=True)
            torch.cuda.synchronize()
            for _ in range(API_CALLS):
                t = time.perf_counter()
                la.align(img, return_all=True)
                torch.cuda.synchronize()
                turns[turn].append(1e3 * (time.perf_counter() - t))
    align_ms = turns["replay"][-API_CALLS:]

    p_r = np.stack([la.ref_kp["y"][out["matches"][:, 0]], la.ref_kp["x"][out["matches"][:, 0]]], 1)
    p_i = np.stack([kp["y"][out["matches"][:, 1]], kp["x"][out["matches"][:, 1]]], 1)
    parts = {
        "keypoints": lambda: la.sift.keypoints(img),
        "match": lambda: la.match_plan.match_index(la.ref_kp, kp),
        "fit": lambda: fit_affine(p_i, p_r),
        "warp": lambda: match_align.affine_warp(img, out["matrix"], out["offset"],
                                                device=dev).cpu().numpy(),
    }
    split = {k: host_ms(fn) for k, fn in parts.items()}
    with eager_programs():
        split.update({f"{k}_eager": host_ms(parts[k]) for k in ("keypoints", "match", "warp")})
    l2_ms = host_ms(lambda: l2.match_index(la.ref_kp, kp))
    orsa_ms = host_ms(lambda: la.align(img, orsa=True))
    rows = {}
    for turn in ("replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            for name in ("match", "warp"):
                n_l, d = profile_calls(parts[name])
                rows[f"{name}_{turn}"] = {"cuda_launches": n_l, "device_ms": d,
                                          "host_syncs": len(host_syncs(parts[name]))}
            n_l, d = profile_calls(lambda: l2.match_index(la.ref_kp, kp))
            rows[f"l2_{turn}"] = {"cuda_launches": n_l, "device_ms": d}
    syncs = host_syncs(lambda: la.align(img))
    syncs_orsa = host_syncs(lambda: la.align(img, orsa=True))
    n1, n2 = len(la.ref_kp), len(kp)
    report = {"align_ms": align_ms, "align_ms_mean": float(np.mean(align_ms)),
              "align_ms_turns": turns, "split_ms": split, "orsa_align_ms": orsa_ms,
              "keypoints": [n1, n2], "matches": len(out["matches"]),
              "buckets": [pads[0][0].shape[0], pads[1][0].shape[0]],
              "l1_match": {"ms": split["match"], "ms_eager": split["match_eager"],
                           **rows["match_replay"], "eager": rows["match_eager"],
                           "int_ops": 3 * 128 * n1 * n2},
              "l2_match": {"ms": l2_ms, **rows["l2_replay"], "eager": rows["l2_eager"]},
              "warp": {"ms": split["warp"], "ms_eager": split["warp_eager"],
                       **rows["warp_replay"], "eager": rows["warp_eager"],
                       "bytes": 3 * 4 * SHAPE[0] * SHAPE[1]},
              "host_syncs": len(syncs), "host_syncs_orsa": len(syncs_orsa)}
    print(f"align {SHAPE} ms (host clock, host image in, host result out, synchronised; "
          f"the detector, matcher and warp replayed): {[round(v, 3) for v in align_ms]} (mean "
          f"{report['align_ms_mean']:.3f}); in turns replayed "
          f"{[round(v, 3) for v in turns['replay']]}, eager "
          f"{[round(v, 3) for v in turns['eager']]}  [{nvidia_smi_line()}]; split "
          f"{ {k: round(v, 3) for k, v in split.items()} }; orsa align {orsa_ms:.3f} ms; "
          f"keypoints {n1} / {n2}, matches {len(out['matches'])}", flush=True)
    for name in ("match", "l2", "warp"):
        r, e = rows[f"{name}_replay"], rows[f"{name}_eager"]
        print(f"{name} (L1, the default)" if name == "match" else name,
              f"replayed: {r['cuda_launches']:g} CUDA launches, {r['device_ms']:.4f} device ms "
              f"a call{', %d host syncs' % r['host_syncs'] if 'host_syncs' in r else ''}; "
              f"eager: {e['cuda_launches']:g} launches, {e['device_ms']:.4f} device ms"
              f"{', %d host syncs' % e['host_syncs'] if 'host_syncs' in e else ''}", flush=True)
    print(f"host synchronisations in one align call: {len(syncs)} (orsa: {len(syncs_orsa)})",
          flush=True)
    for line in sorted(set(syncs + syncs_orsa)):
        print("  sync:", line[:160])
    print("api_align:", json.dumps(report), flush=True)
    return report


def check_invariance(dev) -> dict:
    """Phase B: the invariance battery (sift_pyocl_tpu_torch/utils/
    invariance.py) through the port at 256x256 on the card: default
    SiftConfig, both scenes, all 9 cases against FLOORS, the double_im_size
    zoom fence and the angle fence; the plans' replayed buffers bit-equal
    to their eager detectors' on both scenes."""
    from sift_pyocl_tpu_torch import MatchPlan, SiftConfig, SiftPlan
    from sift_pyocl_tpu_torch.utils import invariance as inv

    plan = SiftPlan(inv.SHAPE, device=dev)
    mp = MatchPlan(device=dev)
    failures, rows = [], {}
    for scene, img in inv.scenes().items():
        kp0 = plan.keypoints(img)
        assert len(kp0) >= 50, f"{scene}: {len(kp0)} keypoints"
        check_buffers_equal(f"[invariance] {scene}: replay against eager",
                            plan.keypoints_raw(img), plan._fn(torch.as_tensor(img).to(dev)))
        for case in inv.CASES:
            res = inv.run_case(plan, mp, img, kp0, case, dev)
            floor = inv.FLOORS[(scene, case[0])]
            rows[f"{scene}/{case[0]}"] = {k: res[k] for k in ("rep", "prec", "eligible",
                                                             "matches")}
            print(f"[invariance] {scene}/{case[0]}: repeatability {res['rep']:.3f} "
                  f"({res['hits']}/{res['eligible']}), precision {res['prec']:.3f}, "
                  f"matches {res['matches']}; floors rep {floor[0]}, precision {floor[1]}, "
                  f"eligible {floor[2]}, matches {floor[3]}", flush=True)
            failures += inv.floor_failures(scene, case[0], res)
        frac, n_match = inv.angle_fence(plan, mp, img, kp0, dev)
        rows[f"{scene}/angle"] = {"share": frac, "matches": n_match}
        print(f"[invariance] {scene} angle consistency: {frac:.3f} of {n_match} "
              f"(fence {inv.ANGLE_FENCE}, >= 10 matches)", flush=True)
        if frac < inv.ANGLE_FENCE or n_match < 10:
            failures.append(f"{scene}: angle consistency {frac:.3f} of {n_match}")
    plan_d = SiftPlan(inv.SHAPE, config=SiftConfig(double_im_size=True), device=dev)
    rep, n_match = inv.zoom_fence(plan, plan_d, mp, dev)
    for img in inv.scenes().values():
        check_buffers_equal("[invariance] double_im_size: replay against eager",
                            plan_d.keypoints_raw(img), plan_d._fn(torch.as_tensor(img).to(dev)))
    print("[invariance] the plans' replayed buffers are bit-equal to their eager detectors' on "
          "both scenes (default and double_im_size)", flush=True)
    rows["double_im_size/zoom_out"] = {"rep": rep, "matches": n_match}
    print(f"[invariance] double_im_size zoom_out: repeatability {rep:.3f}, matches {n_match} "
          f"(fence {inv.ZOOM_FENCE[0]}, {inv.ZOOM_FENCE[1]})", flush=True)
    if rep < inv.ZOOM_FENCE[0] or n_match < inv.ZOOM_FENCE[1]:
        failures.append(f"double_im_size zoom fence: {rep:.3f}, {n_match} matches")
    print("invariance:", json.dumps(rows), flush=True)
    assert not failures, "; ".join(failures)
    return rows


# Phase C: BASELINE config 4, built as tools/bench_configs.py::config4_sfm
# builds it (a 50-frame rendered arc, 120 landmarks; SiftConfig(kp_per_
# octave_cap=256), ba_every=8, the L1 matcher, loop closure on).  The JAX
# package registered 50 of 50 frames with ATE 0.0155 and 672 map points on
# it (BASELINE.md r5): the gates below hold the port to that outcome.
CONFIG4_SEQ = dict(n_frames=50, n_points=120, image_size=(320, 240), seed=0, arc_deg=40.0)
CONFIG4_POINTS = 672
CONFIG4_FRAME = 20          # the registration profiled (frame id)


# The JAX package's host loop (IncrementalSfM(fused=False)) on this
# sequence with these settings, run once on the CPU by
# tools/jax_cpu_references.py: 50 of 50 registered, ATE 0.01602, 671
# points, 48 loop edges, bootstrap (0, 5).  Its ATE is below 0.04, so the
# port's host loop is held to the fused path's 0.05.
CONFIG4_HOST_JAX = {"registered": 50, "ate": 0.01602}
CONFIG4_HOST_ATE = 0.05


def config4_sequence():
    """Config 4's 50 frames and their truth, rendered in NumPy (~40 s)."""
    from sift_pyocl_tpu_torch.utils.render3d import render_sequence

    t = time.perf_counter()
    K, frames, gtR, gtT = render_sequence(**CONFIG4_SEQ)
    render_s = time.perf_counter() - t
    print(f"[config4] rendered {len(frames)} frames {frames[0].shape} in {render_s:.1f} s "
          "(NumPy, host)", flush=True)
    return K, frames, gtR, gtT, render_s


def captured_registration(sfm, frame: int, method: str = "_register_frame") -> list:
    """Wrap sfm's registration `method` so that the call registering
    `frame` keeps a copy of its arguments (filled in the list returned)."""
    orig, kept = getattr(sfm, method), []

    def wrapper(f, *args):
        if f == frame and not kept:
            kept.append((f,) + tuple(np.array(a) if isinstance(a, np.ndarray) else a
                                     for a in args))
        return orig(f, *args)

    setattr(sfm, method, wrapper)
    return kept


def graph_buckets(cache, spec_at: int) -> list:
    """The row counts (the P or N bucket: input `spec_at`'s first dimension)
    of the keys a graph cache holds."""
    return sorted({key[1][spec_at][0][0] for key in cache._graphs})


@contextlib.contextmanager
def last_ba_call(kept: list):
    """Keep the arguments of the last run_ba call IncrementalSfM makes (the
    final BA's) in `kept`."""
    from sift_pyocl_tpu_torch.sfm import pipeline

    orig = pipeline.run_ba

    def recorded(*args, **kw):
        kept[:] = [(args, kw)]
        return orig(*args, **kw)

    pipeline.run_ba = recorded
    try:
        yield
    finally:
        pipeline.run_ba = orig


SPLIT_PHASES = ("bootstrap", "loop_closure")


@contextlib.contextmanager
def sfm_split(sfm, split: dict, kept: dict):
    """Time the parts of one IncrementalSfM run's bootstrap and loop closure
    by wrapping the methods and pipeline functions they call (frame
    detection, the probes, the host matcher, the two-view inits,
    RANSAC-PnP and the pose graph): a wrapper synchronises the card before
    and after its call and adds the call's host seconds, less those of the
    wrapped calls inside it, and one call to split[phase][part] = [s,
    calls], the phase (bootstrap, register, loop_closure, final) being the
    one the run is in.  `kept` gets the arguments of the run's last
    optimize_pose_graph, loop_probe and two-view init calls.  Wrap inside eager_programs,
    so that an eager turn times the eager functions."""
    from sift_pyocl_tpu_torch.sfm import pipeline

    phase, inner = ["bootstrap"], []

    def timed(fn, part, keep=None):
        def wrapper(*args, **kw):
            if keep:
                kept[keep] = (args, kw)
            if part is None:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            inner.append(0.0)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                dt_inner = inner.pop()
                if inner:
                    inner[-1] += dt
                rec = split.setdefault(phase[0], {}).setdefault(part, [0.0, 0])
                rec[0] += dt - dt_inner
                rec[1] += 1
        return wrapper

    def marks(fn, during, after):
        def wrapper(*args, **kw):
            phase[0] = during
            try:
                return fn(*args, **kw)
            finally:
                phase[0] = after
        return wrapper

    on_sfm = {"_bootstrap_fast": marks(sfm._bootstrap_fast, "bootstrap", "register"),
              "_bootstrap": marks(sfm._bootstrap, "bootstrap", "register"),
              "_pose_graph_close": marks(sfm._pose_graph_close, "loop_closure", "final"),
              "_boot_probe": timed(sfm._boot_probe, "probe"),
              "_loop_probe": timed(sfm._loop_probe, "probe"),
              "_match": timed(sfm._match, "match"),
              "_run_two_view_init": timed(sfm._run_two_view_init, "two_view", "two_view")}
    on_pipeline = {"ransac_pnp": timed(pipeline.ransac_pnp, "ransac_pnp"),
                   "optimize_pose_graph": timed(pipeline.optimize_pose_graph, "pose_graph",
                                                "pose_graph"),
                   "loop_probe": timed(pipeline.loop_probe, None, "loop_probe")}
    saved = {name: getattr(pipeline, name) for name in on_pipeline}
    detect = timed(sfm.sift.keypoints_raw, "detect")
    vars(sfm).update(on_sfm)
    vars(sfm.sift)["keypoints_raw"] = detect
    for name, fn in on_pipeline.items():
        setattr(pipeline, name, fn)
    try:
        yield
    finally:
        for name in on_sfm:
            vars(sfm).pop(name)
        vars(sfm.sift).pop("keypoints_raw")
        for name, fn in saved.items():
            setattr(pipeline, name, fn)


def split_line(split: dict, phases: dict) -> dict:
    """Each of SPLIT_PHASES's parts as {part: [s, calls]}, with the rest of
    the phase's phase_times seconds under "rest"."""
    out = {}
    for ph in SPLIT_PHASES:
        parts = {k: [round(v[0], 4), v[1]] for k, v in split.get(ph, {}).items()}
        parts["rest"] = round(phases[ph] - sum(v[0] for v in split.get(ph, {}).values()), 4)
        out[ph] = parts
    return out


def sfm_run(tag: str, seq, kw, eager: bool) -> dict:
    """One IncrementalSfM run over config 4's frames, its programs replayed
    (or with `eager` their eager functions patched in), with the run's
    gates: 50 of 50 registered (the host loop: at least the JAX package's
    count), ATE below its bound, map points within 20 % of 672 (fused), a
    loop edge (fused); an eager run launches K1-K6 once a frame detected
    and K7 never (the wrappers' counters), a replayed run captures at most
    one detector key and one registration (or RANSAC-PnP) key a bucket
    (its counters count the captures' bodies, two each), at most one LM
    key a BA call (periodic and final), at most one pose-graph key, and on
    the fused path at most one loop-probe key and two boot-probe keys (a
    chunk of 8 and a short last chunk; the host loop none).  The run's
    bootstrap and loop closure are split (sfm_split) and printed; a
    replayed run captures at most one two-view key a bucket of matches
    (256, 512, ... rows)."""
    from sift_pyocl_tpu_torch.models.sift import DETECT_GRAPHS
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sift_pyocl_tpu_torch.sfm import (IncrementalSfM, ate_rmse, ba, camera_centers,
                                          pipeline, pnp, posegraph, twoview)

    K, frames, gtR, gtT, _ = seq
    fused = kw.get("fused", True)
    reg_cache, at = (pipeline.REGISTER_GRAPHS, 8) if fused else (pnp.PNP_GRAPHS, 3)
    caches = {"detector": DETECT_GRAPHS, "registration" if fused else "ransac_pnp": reg_cache,
              "lm": ba.LM_GRAPHS, "pair": pipeline.PAIR_GRAPHS,
              "posegraph": posegraph.POSEGRAPH_GRAPHS, "boot_probe": pipeline.BOOT_PROBE_GRAPHS,
              "loop_probe": pipeline.LOOP_PROBE_GRAPHS, "two_view": twoview.TWOVIEW_GRAPHS}
    before = {k: c.captures for k, c in caches.items()}
    sfm = IncrementalSfM(K, frames[0].shape, **kw)
    kept = captured_registration(sfm, CONFIG4_FRAME,
                                 "_register_frame" if fused else "_register_host")
    kept_ba, split, kept_loop = [], {}, {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with eager_programs() if eager else contextlib.nullcontext(), last_ba_call(kept_ba), \
            sfm_split(sfm, split, kept_loop):
        res = sfm.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts()
    captures = {k: c.captures - before[k] for k, c in caches.items()}
    det, regs = captures["detector"], captures["registration" if fused else "ransac_pnp"]
    assert res is not None, f"{tag}: bootstrap failed"
    reg = res.frames_registered
    ate = ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg]))
    buckets = graph_buckets(reg_cache, at)
    n_ba = len(res.Rs) // sfm.ba_every + 1        # periodic BAs and the final one
    print(f"[config4] {tag}: {wall:.3f} s ({wall / len(frames):.4f} s/frame), {len(reg)} "
          f"registered, ATE {ate:.5f}, {len(res.points)} points, {res.n_obs} observations, "
          f"{sfm.n_loop_edges} loop edges, bootstrap (0, {reg[1]}), {sfm.n_detected} frames "
          f"detected; graph captures {captures} ({'registration' if fused else 'RANSAC-PnP'} "
          f"buckets held {buckets}, {n_ba} BA calls); phases (s) "
          f"{ {k: round(v, 4) for k, v in sfm.phase_times.items()} }; memory "
          f"reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB  [{nvidia_smi_line()}]",
          flush=True)
    parts = split_line(split, sfm.phase_times)
    print(f"[config4] {tag}: split (s, calls; synchronised at each part) {parts}", flush=True)
    if fused:
        assert len(reg) == len(frames), f"{tag}: {len(reg)} of {len(frames)} registered"
        assert ate < 0.05, f"{tag}: ATE {ate}"
        assert abs(len(res.points) - CONFIG4_POINTS) <= 0.2 * CONFIG4_POINTS, len(res.points)
        assert sfm.n_loop_edges >= 1, f"{tag}: no loop edge"
    else:
        assert len(reg) >= CONFIG4_HOST_JAX["registered"], f"{tag}: {len(reg)} registered"
        assert ate < CONFIG4_HOST_ATE, f"{tag}: ATE {ate}"
        assert sfm.n_detected == len(frames)
    bodies = sfm.n_detected if eager else GRAPH_BODIES * det
    for name in FRONTEND:
        assert counts[name] == bodies, \
            f"{tag}: {name} launched {counts[name]} times, want {bodies} ({sfm.n_detected} frames)"
    assert counts["best2_l2"] == 0, f"{tag}: K7 launched {counts['best2_l2']} times"
    if eager:
        assert not any(captures.values()), f"{tag}: the eager run captured {captures}"
    else:
        assert det <= 1 and regs <= len(buckets), (det, regs, buckets)
        assert len(reg_cache) == len(buckets) or reg_cache.max_graphs < len(buckets)
        assert all(b >= 256 and b & (b - 1) == 0 for b in buckets), buckets
        assert captures["lm"] <= n_ba, (captures, n_ba)
        assert captures["posegraph"] <= 1, captures
        assert (captures["loop_probe"] <= 1 and captures["boot_probe"] <= 2) if fused else \
            (captures["loop_probe"] == captures["boot_probe"] == 0), captures
        tv_buckets = graph_buckets(twoview.TWOVIEW_GRAPHS, 1)
        assert captures["two_view"] <= len(tv_buckets), (captures, tv_buckets)
        assert all(b >= 256 and b & (b - 1) == 0 for b in tv_buckets), tv_buckets
    return dict(sfm=sfm, res=res, wall=wall, ate=ate, counts=counts, kept=kept,
                kept_ba=kept_ba, kept_loop=kept_loop, detected=sfm.n_detected,
                phases=dict(sfm.phase_times), split=parts,
                captures={**captures, "buckets": buckets})


def lm_report(tag: str, kept_ba, dev) -> dict:
    """One LM iteration of the run's final BA (its padded problem, from lam
    1e-3): the replay bit-equal to the eager lm_iteration, and each one's
    host ms, CUDA launches and device ms (torch.profiler), and host syncs
    (its inputs on the card)."""
    from sift_pyocl_tpu_torch.sfm import ba

    (params, obs, K), kw = kept_ba[0][0][:3], kept_ba[0][1]
    _, params, obs, K, free = ba._ba_inputs(params, obs, K, (0,), dev)
    lam = torch.full((), 1e-3, device=dev)
    args = (params, obs, K, lam, free)
    kw = dict(huber_px=kw["huber_px"], cg_iters=kw["cg_iters"], n_points=params.X.shape[0])
    got = ba.lm_iteration_replayed(*args, **kw)
    want = ba.lm_iteration(*args, **kw)
    check_buffers_equal(f"{tag}: LM iteration params", got[0], want[0])
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])), f"{tag}: LM lam/cost"
    rows = {}
    for turn, fn in (("replay", lambda: ba.lm_iteration_replayed(*args, **kw)),
                     ("eager", lambda: ba.lm_iteration(*args, **kw))):
        n_l, d = profile_calls(fn)
        rows[turn] = {"ms": host_ms(fn, calls=10), "cuda_launches": n_l, "device_ms": d,
                      "host_syncs": len(host_syncs(fn))}
    shape = {"C": int(params.Rs.shape[0]), "Mp": int(obs.w.shape[0]),
             "Pp": int(params.X.shape[0]), "M": int(obs.w.sum())}
    print(f"[config4] {tag}: one LM iteration of the final BA {shape}, replayed "
          f"{rows['replay']} against eager {rows['eager']} (bit-equal)", flush=True)
    return {**shape, **rows}


def loop_report(tag: str, kept_loop, dev) -> dict:
    """The run's pose-graph call (20 Gauss-Newton steps) and, on the fused
    path, its loop probe, on their arguments as the run made them: the
    replay bit-equal to the eager function, and each one's host ms, CUDA
    launches and device ms (torch.profiler), and host syncs."""
    from sift_pyocl_tpu_torch.sfm import pipeline, posegraph

    started = time.perf_counter()
    calls = [("pose_graph", posegraph.optimize_pose_graph, posegraph._optimize_pose_graph_eager),
             ("loop_probe", pipeline.loop_probe, pipeline._loop_probe_eager)]
    rows = {}
    for name, replay, eager in calls:
        if name not in kept_loop:
            continue
        args, kw = kept_loop[name]
        got, want = replay(*args, **kw), eager(*args, **kw)
        got, want = (tuple(x) if isinstance(x, tuple) else (x,) for x in (got, want))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{tag}: {name} replay differs"
        rows[name] = {"shapes": [list(np.shape(a)) for a in args if hasattr(a, "shape")]}
        # a pose-graph call makes ~20000 launches (an eager one takes ~1 s of
        # host): one call a profiler session, the fullest of three
        for turn, fn in (("replay", lambda: replay(*args, **kw)),
                         ("eager", lambda: eager(*args, **kw))):
            events = cuda_events(fn, calls=1, sessions=3)
            rows[name][turn] = {"ms": host_ms(fn, calls=3), "cuda_launches": len(events),
                                "device_ms": sum(e.device_time_total for e in events) / 1e3,
                                "host_syncs": len(host_syncs(fn))}
        print(f"[config4] {tag}: one {name} call {rows[name]['shapes']}, replayed "
              f"{rows[name]['replay']} against eager {rows[name]['eager']} (bit-equal)",
              flush=True)
    print(f"[config4] {tag}: the pose-graph and loop-probe report took "
          f"{time.perf_counter() - started:.1f} s", flush=True)
    return rows


TWOVIEW_KERNELS = ("sym_eig_small", "svd3")


def twoview_report(tag: str, sfm, kept_loop) -> dict:
    """The run's last two-view init (its matches padded to their bucket as
    IncrementalSfM pads them): initialize_two_view's replay bit-equal to
    _initialize_two_view_eager, its host ms (mean of 10 synchronised
    calls) beside eager's and 0 host syncs; then
    IncrementalSfM._run_two_view_init (padding, the init, its copy home)
    replayed and eager: host ms, CUDA launches and device ms
    (torch.profiler), host syncs; and the replay's K12 and K13 launches by
    kernel name (each wrapper's launches a replayed init).  Host clocks are
    read before any profiler session."""
    from sift_pyocl_tpu_torch.sfm import pipeline, twoview

    (m, uv0, uvb), _ = kept_loop["two_view"]
    n = len(m)
    P = pipeline._pow2_pad(n)
    args = (sfm.Kt, pipeline._pad_rows(uv0, P, np.float32), pipeline._pad_rows(uvb, P, np.float32),
            np.arange(P) < n)
    kw = dict(thresh_px=sfm.reproj_px)

    def replay():
        return twoview.initialize_two_view(3, *args, **kw)

    def eager():
        return twoview._initialize_two_view_eager(3, *args, **kw)

    got, want = replay(), eager()
    assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{tag}: two-view replay differs"
    rows = {"matches": n, "bucket": P, "inliers": int(got.n_inliers),
            "bare": {"replay_ms": host_ms(replay, calls=10), "eager_ms": host_ms(eager, calls=10),
                     "replay_host_syncs": len(host_syncs(replay)),
                     "eager_host_syncs": len(host_syncs(eager))}}
    assert rows["bare"]["replay_host_syncs"] == 0, f"{tag}: a two-view replay synchronised"

    def one():
        return sfm._run_two_view_init(m, uv0, uvb)

    for turn in ("replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            rows[turn] = {"ms": host_ms(one, calls=10)}
    for turn in ("replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            n_l, d = profile_calls(one)
            rows[turn].update(cuda_launches=n_l, device_ms=d, host_syncs=len(host_syncs(one)))
    per_call = kernel_counts(replay)
    launches = {name: per_call[k] for name in TWOVIEW_KERNELS for k in WRAPPER_KERNELS[name]}
    assert all(v > 0 for v in launches.values()), f"{tag}: a replayed init launched {launches}"
    rows["kernel_launches"] = launches
    print(f"[config4] {tag}: one two-view init ({n} matches, bucket {P}), with its padding and "
          f"copy home: replayed {rows['replay']} against eager {rows['eager']}; the bare call "
          f"{rows['bare']} (bit-equal); K12 / K13 launches a replayed init {launches}",
          flush=True)
    return rows


def check_runs_equal(tag: str, runs, want) -> None:
    for r in runs:
        for field in ("Rs", "ts", "points"):
            x, y = getattr(r["res"], field), getattr(want["res"], field)
            assert x.shape == y.shape and np.array_equal(x, y), f"{tag}: runs differ in {field}"


FRAME_CALLS = 20     # timed calls of one registered frame, each turn


def frame_report(tag: str, one_frame) -> dict:
    """One registered frame (detection included), replayed and eager: host
    ms (the mean, median, least and most of FRAME_CALLS calls, each
    synchronised), CUDA launches and device ms (torch.profiler), host syncs;
    the replayed frame launches K1-K6 once (by kernel name) and K7 never."""
    rows = {}
    for turn in ("replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            out = one_frame()
            calls = []
            for _ in range(FRAME_CALLS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                one_frame()
                torch.cuda.synchronize()
                calls.append(1e3 * (time.perf_counter() - t))
            launches, dev_ms = profile_calls(one_frame)
            syncs = host_syncs(one_frame)
            rows[turn] = {"ms": float(np.mean(calls)), "ms_median": float(np.median(calls)),
                          "ms_min": min(calls), "ms_max": max(calls), "cuda_launches": launches,
                          "device_ms": dev_ms, "host_syncs": len(syncs)}
            if turn == "replay":
                check_wrapper_launches(f"{tag}: one replayed frame", kernel_counts(one_frame),
                                       {name: 1 for name in FRONTEND})
        r = rows[turn]
        print(f"[config4] {tag}, one registered frame (frame {CONFIG4_FRAME}, detection "
              f"included), {turn}: {r['ms']:.3f} ms host clock (median {r['ms_median']:.3f}, "
              f"{r['ms_min']:.3f}-{r['ms_max']:.3f} over {FRAME_CALLS} calls), {launches:g} "
              f"CUDA launches, {dev_ms:.4f} device ms, {len(syncs)} host synchronisations",
              flush=True)
        for line in sorted(set(syncs)):
            print("  sync:", line[:160])
    return {**rows["replay"], "eager": rows["eager"], "out": out}


def check_sfm(dev, seq) -> dict:
    """Phase C: IncrementalSfM over the config-4 sequence on the card, three
    runs in turns (replayed, eager, replayed; sfm_run's gates each), the
    replayed runs bit-equal to the eager run in Rs, ts and points (the
    second replayed run captures nothing).  Prints each run's wall time,
    s/frame and phase_times; for one registered frame (detection included)
    replayed beside eager its host ms, CUDA launches and device ms
    (torch.profiler) and host synchronisations (sync debug mode), and its
    split; and the BA's segment sum held to a float64 sum and to itself on
    the final BA's ids.  Then the host loop (check_sfm_host_loop)."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.match import match_descriptors_dense
    from sift_pyocl_tpu_torch.sfm import pipeline, pnp
    from sift_pyocl_tpu_torch.sfm.segment import segment_sum, segments

    K, frames, gtR, gtT, render_s = seq
    kw = dict(cfg=SiftConfig(kp_per_octave_cap=256), ba_every=8, device=dev)
    runs = {f"run {i} ({turn})": sfm_run(f"run {i} ({turn})", seq, kw, turn == "eager")
            for i, turn in enumerate(("replayed", "eager", "replayed"))}
    first, eager, last = runs.values()
    check_runs_equal("config 4", (first, last), eager)
    assert not any(v for k, v in last["captures"].items() if k != "buckets"), last["captures"]
    print("[config4] the replayed runs are bit-equal to the eager run in Rs, ts and points; "
          "the second replayed run captured nothing", flush=True)
    lm = lm_report("fused", last["kept_ba"], dev)
    loop = loop_report("fused", last["kept_loop"], dev)
    assert set(loop) == {"pose_graph", "loop_probe"}, list(loop)
    two_view = twoview_report("fused", last["sfm"], last["kept_loop"])
    # the two-view inits of each run's bootstrap, replayed and eager (s,
    # calls); K12's and K13's launches on the main path: the first replayed
    # run's inits times a replayed init's launches by kernel name (its
    # counters count the captures' warm-up and capture), and the eager
    # run's counters, each init's launches
    two_view["split"] = {k: r["split"]["bootstrap"].get("two_view") for k, r in runs.items()}
    inits = {k: r["split"]["bootstrap"]["two_view"][1] for k, r in runs.items()}
    per_init = two_view["kernel_launches"]
    two_view["launches"] = {name: inits[next(iter(runs))] * per_init[name]
                            for name in TWOVIEW_KERNELS}
    two_view["capture_launches"] = {name: first["counts"][name] for name in TWOVIEW_KERNELS}
    for name in TWOVIEW_KERNELS:
        assert two_view["capture_launches"][name] > 0, f"{name}: no launch in the first run"
        want_eager = inits[list(runs)[1]] * per_init[name]
        assert eager["counts"][name] == want_eager, (name, eager["counts"][name], want_eager)
    print(f"[config4] two-view inits in each run's bootstrap (s, calls) {two_view['split']}; "
          f"K12 / K13 launches on the first replayed run {two_view['launches']} (counters at "
          f"its captures {two_view['capture_launches']}), eager run "
          f"{ {n: eager['counts'][n] for n in TWOVIEW_KERNELS} }", flush=True)

    # one registered frame, detection included: replayed beside eager
    sfm = last["sfm"]
    assert last["kept"], f"frame {CONFIG4_FRAME} was not registered"
    args = last["kept"][0]

    def one_frame():
        sfm._bufs.pop(CONFIG4_FRAME, None)
        return sfm._register_frame(*args)

    frame = frame_report("fused", one_frame)
    out = frame.pop("out")
    assert int(out.n_inl) >= 10, int(out.n_inl)
    # its split: detection, the L1 map match, RANSAC-PnP on the map's bucket
    # (the same inputs), each replayed and eager where it is a graph
    buf = sfm._buf(CONFIG4_FRAME)
    n = len(args[3])
    P = pipeline._pow2_pad(n)
    mdesc, mvalid, mX = (sfm._dev(a) for a in (args[2], args[1], args[3]))
    pad, uv_p, keep_p = (pipeline._pad_rows(a, P, np.float32)
                         for a in (args[3], out.uv, out.keep))
    R0, t0 = sfm._dev(args[7]), sfm._dev(args[8])
    split = {}
    for name, fn in (
            ("detect", lambda: sfm.sift.keypoints_raw(frames[CONFIG4_FRAME])),
            ("detect_eager", lambda: sfm.sift._fn(torch.from_numpy(
                np.asarray(frames[CONFIG4_FRAME], np.float32)).to(dev))),
            ("match_l1", lambda: match_descriptors_dense(mdesc, mvalid, buf.desc, buf.valid,
                                                         metric="L1", ratio_sq=0.7)),
            ("ransac_pnp", lambda: pnp.ransac_pnp(0, sfm.Kt, R0, t0, pad, uv_p, keep_p,
                                                  thresh_px=3.0)),
            ("ransac_pnp_eager", lambda: pnp._ransac_pnp_eager(0, sfm.Kt, R0, t0, pad, uv_p,
                                                               keep_p, thresh_px=3.0)),
            ("register_no_detect", lambda: sfm._register_frame(*args))):
        n_l, d = profile_calls(fn)
        split[name] = {"ms": host_ms(fn), "cuda_launches": n_l, "device_ms": d}
    print(f"[config4] its split: { {k: {m: round(v, 4) for m, v in r.items()} for k, r in split.items()} }",
          flush=True)

    # the segment sum of the scatter-form BA on the final BA's camera and
    # point ids: the same bits on every call, within 1e-4 of float64
    res = last["res"]
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, len(res.points), (res.n_obs,), generator=gen)
    vals = torch.randn((res.n_obs, 6, 6), generator=gen)
    seg = segments(ids.to(dev), len(res.points))
    sums = [segment_sum(vals.to(dev), seg) for _ in range(3)]
    assert all(torch.equal(sums[0], s_) for s_ in sums[1:]), "segment_sum not deterministic"
    want = torch.zeros((len(res.points), 6, 6), dtype=torch.float64).index_add_(
        0, ids, vals.double())
    seg_err = float((sums[0].cpu().double() - want).abs().max())
    assert seg_err < 1e-4, seg_err
    seg_ms = cuda_ms(lambda: segment_sum(vals.to(dev), seg), 20)
    print(f"[config4] segment_sum over {res.n_obs} observations: 3 calls bit-equal, "
          f"{seg_err:.3g} from float64, {seg_ms:.4f} ms a call", flush=True)
    host = check_sfm_host_loop(seq, kw, frame)
    report = {"frames": len(frames), "render_s": render_s,
              "wall_s": {k: r["wall"] for k, r in runs.items()},
              "s_per_frame": {k: r["wall"] / len(frames) for k, r in runs.items()},
              "phase_times": {k: r["phases"] for k, r in runs.items()},
              "split": {k: r["split"] for k, r in runs.items()},
              "captures": {k: r["captures"] for k, r in runs.items()},
              "registered": len(res.frames_registered), "ate": last["ate"],
              "points": int(len(res.points)), "observations": int(res.n_obs),
              "loop_edges": sfm.n_loop_edges, "bootstrap": res.frames_registered[1],
              "detected": last["detected"],
              "launch_counts": {k: eager["counts"][k] for k in FRONTEND},
              "frame": {"id": CONFIG4_FRAME, **frame, "split": split},
              "lm_iteration": lm, "loop_closure": loop, "two_view": two_view,
              "segment_sum": {"max_err_f64": seg_err, "ms": seg_ms},
              "host_loop": host}
    print("config4:", json.dumps(report), flush=True)
    return report


def check_sfm_host_loop(seq, kw, fused_frame) -> dict:
    """Phase C's host loop: IncrementalSfM(fused=False) over config 4's
    frames replayed, eager and replayed (sfm_run's gates each), the
    replayed runs bit-equal to the eager run in Rs, ts and points, the
    second capturing nothing.  Prints s/frame, one LM iteration of the
    final BA, and one registered frame's (detection included) host ms,
    CUDA launches, device ms and host syncs replayed beside eager and
    beside the fused path's."""
    runs = [sfm_run(f"host loop (fused=False, {turn})", seq, {**kw, "fused": False},
                    turn == "eager") for turn in ("replayed", "eager", "replayed")]
    check_runs_equal("host loop", runs[::2], runs[1])
    assert not any(v for k, v in runs[2]["captures"].items() if k != "buckets"), \
        runs[2]["captures"]
    print("[config4] host loop: the replayed runs are bit-equal to the eager run in Rs, ts and "
          "points; the second replayed run captured nothing", flush=True)
    lm = lm_report("host loop", runs[2]["kept_ba"], kw["device"])
    sfm, kept = runs[0]["sfm"], runs[0]["kept"]
    assert kept, f"host loop: frame {CONFIG4_FRAME} was not registered"
    args = kept[0]

    def one_frame():
        sfm._bufs.pop(CONFIG4_FRAME, None)
        sfm._kps_cache.pop(CONFIG4_FRAME, None)
        sfm._kp_np(CONFIG4_FRAME)
        return sfm._register_host(*args)

    frame = frame_report("host loop", one_frame)
    out = frame.pop("out")
    assert out.n_inl >= 10, out.n_inl
    print(f"[config4] host loop frame {frame['ms']:.3f} ms replayed against fused "
          f"{fused_frame['ms']:.3f} ms", flush=True)
    r = runs[2]
    return {"wall_s": {"replayed": [runs[0]["wall"], r["wall"]], "eager": runs[1]["wall"]},
            "s_per_frame": r["wall"] / len(seq[1]), "registered": len(r["res"].frames_registered),
            "ate": r["ate"], "points": int(len(r["res"].points)),
            "loop_edges": r["sfm"].n_loop_edges, "bootstrap": r["res"].frames_registered[1],
            "phase_times": {"replayed": [runs[0]["phases"], r["phases"]],
                            "eager": runs[1]["phases"]},
            "split": {"replayed": [runs[0]["split"], r["split"]], "eager": runs[1]["split"]},
            "captures": [runs[0]["captures"], r["captures"]], "lm_iteration": lm,
            "frame": frame}


# Phase D: BASELINE config 3, the batched video frontend.  Frames as
# tools/ab_batch.py makes them (synthetic_scene((1080, 1920), n_blobs=200,
# seed=0) + i), on the card, SiftConfig(): a video stream's frames taken B
# at a time.  Per batch, K1/K2 (or K1m/K2m) run once a frame and K3-K6 (K8
# with "pallas") once over every frame's octaves, up to MAX_ENTRIES entries
# a launch.
BATCHES = (1, 2, 4, 8)
BATCH_SPLIT = 12            # 84 entries: two launches of K3, K4 and K5
BATCH_TURNS = (1, 8, 8, 1)  # ms/frame taken in turns: the host's speed drifts
PIPELINE_FRAMES = 6
LOST_RECORDS = 2            # profiler records a batch's launch gate forgives


def batch_launches(B: int, chunks: int = 1) -> dict:
    """CUDA launches a batch of B frames, by the kernels' own names
    (torch.profiler): K1's six level launches and K2's one cooperative
    launch a frame, one of each of K3-K6 (`chunks` launches of K3-K5,
    _build.entry_chunks, past MAX_ENTRIES entries)."""
    return {"blur_level_kernel": 6 * B, "small_octaves_kernel": B, "compact_kernel": chunks,
            "refine_kernel": chunks, "grad_kernel": chunks, "orient_desc_kernel": 1,
            "mask_kernel": 0}


def batch_frames(n: int, dev) -> torch.Tensor:
    from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

    base = synthetic_scene(SHAPE, n_blobs=200, seed=0)
    return torch.from_numpy(np.stack([base + i for i in range(n)]).astype(np.float32)).to(dev)


def counted(fn):
    """fn()'s result and the launch counters, reset just before it and read
    just after."""
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def check_batch_counts(tag: str, counts: dict, want: dict) -> None:
    """Every kernel wrapper's launches as `want` says, 0 for the others."""
    bad = {k: (n, want.get(k, 0)) for k, n in counts.items() if n != want.get(k, 0)}
    assert not bad, f"{tag}: launches (got, want) {bad}"


def check_frames_equal(tag: str, buf, imgs, cfg, frames=None) -> None:
    """Each frame of a batched buffer equals, in every field and bit, the
    single-frame detect_and_describe of that frame."""
    from sift_pyocl_tpu_torch import detect_and_describe

    for f in frames if frames is not None else range(imgs.shape[0]):
        one = detect_and_describe(imgs[f], cfg)
        for fld in one._fields:
            assert torch.equal(getattr(buf, fld)[f], getattr(one, fld)), \
                f"{tag}: frame {f} differs from its single-frame buffer in {fld}"


def frame_of(buf, f):
    """Frame f of a batched KeypointBuffer."""
    return type(buf)(*[t[f] for t in buf])


def batch_of(buf):
    """A single-frame KeypointBuffer as a batch of one."""
    return type(buf)(*[t[None] for t in buf])


def batch_profile(tag: str, fn, want: dict) -> dict:
    """One batch's CUDA launches and device ms (torch.profiler, the fullest
    of three sessions), its launches of each kernel in `want` gated: none
    more than `want`, and at most LOST_RECORDS fewer in all (a session now
    and then loses a record, and a lost record only ever lowers a count;
    the launch counters show each wrapper's launches exactly)."""
    from sift_pyocl_tpu_torch.utils import profiling

    prof = profiling.device_profile(fn, 1, sessions=3)
    by_name = prof.pop("launches_by_name_per_frame")
    got = {k: sum(n for name, n in by_name.items() if k in name) for k in want}
    if "small_octaves_kernel" in want:    # K2m's kernel name holds K2's
        got["small_octaves_kernel"] -= sum(n for name, n in by_name.items()
                                           if "small_octaves_kernel_masks" in name)
    lost = sum(want.values()) - sum(got.values())
    assert all(got[k] <= want[k] for k in want) and lost <= LOST_RECORDS, \
        f"{tag}: CUDA launches a batch {got}, want {want}"
    return {"cuda_launches": prof["kernel_launches_per_frame"],
            "device_ms": prof["kernel_ms_per_frame"], "busy_share": prof["busy_share"],
            "lost_records": lost}


def check_batched(dev) -> dict:
    """Phase D: detect_and_describe_batched at B = 1, 2, 4, 8 and 12,
    with "pallas" masks at B = 4 and fused masks at B = 2,
    VideoSiftFrontend on the one-card mesh and TwoStagePipeline; every
    frame bit-equal to its single-frame buffer, the launches of each kernel
    gated (counters and profiler), ms/frame in turns."""
    from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe_batched
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.ops.kernels import maskk
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
    from sift_pyocl_tpu_torch.parallel import TwoStagePipeline, VideoSiftFrontend, make_frames_mesh
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets, textured_scene

    cfg = SiftConfig()
    n_oct = cfg.n_octaves(SHAPE)
    imgs = batch_frames(BATCH_SPLIT, dev)
    detect_and_describe_batched(imgs[:2], cfg)     # warm-up: allocator, layouts
    report = {"batches": {}}
    frontend = ("octave0_ladder", "small_octaves_ladder")
    for B in BATCHES + (BATCH_SPLIT,):
        x = imgs[:B]
        chunks = len(_build.entry_chunks(B * n_oct))
        buf, counts = counted(lambda: detect_and_describe_batched(x, cfg))
        check_batch_counts(f"B={B}", counts, {**{k: B for k in frontend},
                                             "compact_masks_multi": chunks,
                                             "refine_multi": chunks, "grad_atlas": chunks,
                                             "orient_desc_fused": 1})
        assert buf.x.shape[0] == B and tuple(buf.counts.shape) == (B, n_oct, 2)
        check_frames_equal(f"B={B}", buf, x, cfg)
        n_kp = [int(v) for v in buf.valid.sum(1)]
        assert min(n_kp) >= MIN_KEYPOINTS, n_kp
        row = {"entries": B * n_oct, "launches_of_k3_k4_k5": chunks, "keypoints": n_kp,
               "counts": {k: counts[k] for k in frontend + VO_KERNELS[2:6]}}
        if B in BATCHES:
            # the batch's plain run, each frame held as phase 1 holds the
            # kernel path to the plain path
            plain = detect_and_describe_batched(x, cfg, plain=True)
            for f in range(B):
                ref = to_keypoint_records(frame_of(plain, f))
                kp = to_keypoint_records(frame_of(buf, f))
                hits, l1 = match_keypoint_sets(ref, kp)
                assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50), (B, f, len(kp), len(ref))
                assert hits >= 0.98 * len(ref) and l1 < 0.1, (B, f, hits, len(ref), l1)
            row["plain"] = {"keypoints": len(ref), "matched": hits, "desc_l1": l1}
        row.update(batch_profile(f"B={B}", lambda: detect_and_describe_batched(x, cfg),
                                 batch_launches(B, chunks)))
        report["batches"][B] = row
        print(f"[config3] B={B}: {B * n_oct} entries, every frame bit-equal to its single-frame "
              f"buffer; {json.dumps(row)}", flush=True)

    # ms/frame, host clock, synchronised, warm, in turns
    turns = []
    for B in BATCH_TURNS:
        x = imgs[:B]
        turns.append((B, host_ms(lambda: detect_and_describe_batched(x, cfg), calls=5) / B))
    for B in (2, 4, BATCH_SPLIT):
        x = imgs[:B]
        turns.append((B, host_ms(lambda: detect_and_describe_batched(x, cfg), calls=3) / B))
    report["ms_per_frame"] = turns
    print(f"[config3] ms/frame (host clock, synchronised, warm; B, ms): "
          f"{[(b, round(m, 3)) for b, m in turns]}", flush=True)
    # the same turns with the masks that take the stencil's ~900 launches a
    # frame off the host: K8 ("pallas") and K1m/K2m ("fused")
    for backend in ("pallas", "fused"):
        cfg_m = SiftConfig(mask_backend=backend)
        t = []
        for B in BATCH_TURNS:
            x = imgs[:B]
            t.append((B, host_ms(lambda: detect_and_describe_batched(x, cfg_m), calls=5) / B))
        report[f"ms_per_frame_{backend}"] = t
        print(f"[config3] ms/frame with mask_backend={backend!r}: "
              f"{[(b, round(m, 3)) for b, m in t]}", flush=True)

    # K8 with each entry's octave number: the 28 entries of B = 4 in one launch
    cfg_p = SiftConfig(mask_backend="pallas")
    x = imgs[:4]
    buf, counts = counted(lambda: detect_and_describe_batched(x, cfg_p))
    check_batch_counts("pallas B=4", counts, {**{k: 4 for k in frontend}, "extrema_masks": 1,
                                              "compact_masks_multi": 1, "refine_multi": 1,
                                              "grad_atlas": 1, "orient_desc_fused": 1})
    check_frames_equal("pallas B=4", buf, x, cfg_p)
    prof_p = batch_profile("pallas B=4", lambda: detect_and_describe_batched(x, cfg_p),
                           {**batch_launches(4), "mask_kernel": 1})
    two = torch.from_numpy(np.stack([imgs[0, :256, :256].cpu().numpy(),
                                     textured_scene((256, 256), seed=1)])).to(dev)
    entries = [d for f in range(2) for _, d in build_scale_space(two[f], cfg_p)]
    k = len(entries) // 2
    ids = list(range(k)) * 2
    got = maskk.extrema_masks(entries, cfg_p, ids)
    assert all(torch.equal(g, w) for g, w in zip(got, maskk.extrema_masks_ref(entries, cfg_p, ids)))
    by_pos = int(maskk.extrema_masks(entries, cfg_p)[k].sum())
    assert by_pos > int(got[k].sum()), (by_pos, int(got[k].sum()))
    report["pallas_b4"] = {"extrema_masks": counts["extrema_masks"], **prof_p,
                           "frame1_octave0_mask_by_id": int(got[k].sum()),
                           "by_position": by_pos}
    print(f"[config3] mask_backend='pallas' B=4: K8 once over {4 * n_oct} entries, frames "
          f"bit-equal; oct_ids: frame 1's octave-0 mask {int(got[k].sum())} pixels (by list "
          f"position {by_pos}); {json.dumps(prof_p)}", flush=True)

    # fused masks: K1m and K2m once a frame, no stencil
    cfg_f = SiftConfig(mask_backend="fused")
    x = imgs[:2]
    maskk.stencil_mask.calls = 0
    buf, counts = counted(lambda: detect_and_describe_batched(x, cfg_f))
    assert maskk.stencil_mask.calls == 0, maskk.stencil_mask.calls
    check_batch_counts("fused B=2", counts, {**{k: 2 for k in FUSED_LADDERS},
                                             "compact_masks_multi": 1, "refine_multi": 1,
                                             "grad_atlas": 1, "orient_desc_fused": 1})
    check_frames_equal("fused B=2", buf, x, cfg_f)
    print("[config3] mask_backend='fused' B=2: K1m and K2m once a frame, frames bit-equal",
          flush=True)

    # the video frontend on the one-card mesh and the two-stage pipeline,
    # host frames in: eager (the counters: every kernel of the frontend once
    # a frame) and replayed (the detector's graph a frame; the two stage
    # graphs), every frame bit-equal, launches by kernel name, ms/frame in
    # turns
    from sift_pyocl_tpu_torch.models.sift import DETECT_GRAPHS
    from sift_pyocl_tpu_torch.parallel import pipeline_octaves

    host = imgs[:PIPELINE_FRAMES].cpu().numpy()
    mesh = make_frames_mesh()
    assert mesh.size == 1 and mesh.devices[0] == dev, mesh
    fe = VideoSiftFrontend(SHAPE, batch=4, mesh=mesh)
    pipe = TwoStagePipeline(SHAPE, cfg)
    assert pipe.d0 == pipe.d1 == dev
    per_frame = {k: 1 for k in frontend + VO_KERNELS[2:6]}
    with eager_programs():
        out, counts = counted(lambda: fe(host[:4]))
        check_batch_counts("VideoSiftFrontend eager", counts, {k: 4 for k in per_frame})
        bufs, counts = counted(lambda: list(pipe.process(host)))
        check_batch_counts("TwoStagePipeline eager", counts,
                           {k: PIPELINE_FRAMES for k in per_frame})
    want_video, want_pipe = out, bufs
    captures = DETECT_GRAPHS.captures, pipeline_octaves.STAGE0_GRAPHS.captures, \
        pipeline_octaves.STAGE1_GRAPHS.captures
    out = fe(host[:4])
    bufs = list(pipe.process(host))
    assert out.x.device == dev and len(bufs) == PIPELINE_FRAMES
    check_buffers_equal("VideoSiftFrontend replayed", out, want_video)
    for f, (b, w) in enumerate(zip(bufs, want_pipe)):
        check_buffers_equal(f"TwoStagePipeline replayed, frame {f}", b, w)
    check_frames_equal("VideoSiftFrontend", out, imgs[:4], cfg)
    for f, b in enumerate(bufs):
        check_frames_equal("TwoStagePipeline", batch_of(b), imgs[f:f + 1], cfg)
    video_launches = check_wrapper_launches("VideoSiftFrontend replayed", kernel_counts(
        lambda: fe(host[:4])), {k: 4 for k in per_frame})
    pipe_launches = check_wrapper_launches("TwoStagePipeline replayed", kernel_counts(
        lambda: list(pipe.process(host))), {k: PIPELINE_FRAMES for k in per_frame})
    new = [c - n for c, n in zip((DETECT_GRAPHS.captures, pipeline_octaves.STAGE0_GRAPHS.captures,
                                  pipeline_octaves.STAGE1_GRAPHS.captures), captures)]
    assert new[1] <= 1 and new[2] <= 1, new
    turns = {"replay": {"video": [], "pipeline": []}, "eager": {"video": [], "pipeline": []}}
    for turn in ("eager", "replay", "replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            turns[turn]["video"].append(host_ms(lambda: fe(host[:4]), calls=3) / 4)
            turns[turn]["pipeline"].append(
                host_ms(lambda: list(pipe.process(host)), calls=2) / len(host))
    rows = {}
    for turn in ("replay", "eager"):
        with eager_programs() if turn == "eager" else contextlib.nullcontext():
            for name, fn, n in (("video", lambda: fe(host[:4]), 4),
                                ("pipeline", lambda: list(pipe.process(host)), len(host))):
                n_l, d = profile_calls(fn, wrapper_calls=n, calls=2)
                rows[f"{name}_{turn}"] = {"cuda_launches_per_frame": n_l,
                                          "device_ms_per_frame": d}
            rows[f"pipeline_{turn}"]["host_syncs"] = len(
                host_syncs(lambda: [None for _ in pipe.process(host)]))
    report["video_ms_per_frame"] = turns["replay"]["video"]
    report["pipeline_ms_per_frame"] = turns["replay"]["pipeline"]
    report["video_pipeline_turns"] = turns
    report["video_pipeline"] = {**rows, "captures": new, "video_launches": video_launches,
                                "pipeline_launches": pipe_launches}
    print(f"[config3] VideoSiftFrontend(batch=4) and TwoStagePipeline ({PIPELINE_FRAMES} frames), "
          f"host frames in: every frame bit-equal, replayed and eager; captures (detector, "
          f"stage 0, stage 1) {new}; ms/frame in turns {json.dumps(turns)}; {json.dumps(rows)}  "
          f"[{nvidia_smi_line()}]", flush=True)
    print("config3:", json.dumps(report), flush=True)
    return report



# Phase E: BASELINE config 5, bench_distributed.py's problem at the JAX
# package's own scale (no cut), and the row-sharded pyramid at 1080x1920
CONFIG5 = dict(n_cams=64, n_points=8192, noise_px=0.5, seed=0, arc_deg=150.0)
CONFIG5_ITERS = 10
CONFIG5_CG = 30                   # DistributedBA's and run_ba's default
CONFIG5_RANKS = 2
RANK_TIMEOUT_S = 240              # a rank that has not reported by then fails the phase
E1_RTOL_EACH = 1e-6               # every iteration's cost, E1 against run_ba
E2_RTOL_EACH = 1e-4               # every iteration's cost, E2 against E1
SPATIAL_SHARDS = {2: 3, 4: 2}     # shards -> octaves the octave rule keeps at 1080 rows


def config5_problem():
    """(K, gt, start, obs): make_problem(**CONFIG5) and its perturbation,
    ts + 0.02 N and X + 0.10 N from default_rng(1) (bench_distributed.py)."""
    from sift_pyocl_tpu_torch.sfm.ba import BAParams
    from sift_pyocl_tpu_torch.sfm.synthetic import make_problem

    K, gt, obs, _ = make_problem(**CONFIG5)
    rng = np.random.default_rng(1)
    start = BAParams(gt.Rs, gt.ts + 0.02 * rng.normal(size=gt.ts.shape),
                     gt.X + 0.10 * rng.normal(size=gt.X.shape))
    return K, gt, start, obs


def lm_ms(run, start, obs, K, short: int = 2, long: int = 12) -> float:
    """Host-clock ms of a warm LM iteration: the difference of a `long` and
    a `short` run (each ends in a host read of its costs) over the extra
    iterations, so the partition and the copies in cancel."""
    run(start, obs, K, iters=short)
    t = time.perf_counter()
    run(start, obs, K, iters=short)
    t_short = time.perf_counter() - t
    t = time.perf_counter()
    run(start, obs, K, iters=long)
    return 1e3 * (time.perf_counter() - t - t_short) / (long - short)


def rank_harness():
    """tests/_torch_ranks.py: the spawn-and-collect harness and the rank
    report that the CPU tests use too."""
    import importlib
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("_torch_ranks")


def config5_rank(rank: int, world: int, store: str, backend: str, queue) -> None:
    """One rank of phase E2 (a spawned process): join the group through a
    file store, run DistributedBA on config 5 on cuda:{rank % cards}, and
    report (rank, {costs, Rs, ts, X, ms per warm LM iteration, host ms in
    all_reduce per warm iteration}) or (rank, "error", traceback)."""
    import os

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")     # the ranks share one host

    def run():
        import torch.distributed as dist

        from sift_pyocl_tpu_torch.parallel import global_ba_mesh, initialize_multihost
        from sift_pyocl_tpu_torch.sfm import DistributedBA

        got = initialize_multihost(f"file://{store}", num_processes=world, process_id=rank,
                                   backend=backend)
        assert got == (rank, world), got
        try:
            K, _, start, obs = config5_problem()
            dba = DistributedBA(global_ba_mesh())
            p, costs = dba.run(start, obs, K, iters=CONFIG5_ITERS)
            ms = lm_ms(dba.run, start, obs, K)
            with counted_all_reduces() as calls:        # a warm run
                dba.run(start, obs, K, iters=CONFIG5_ITERS)
            # less the last call, the point blocks gathered at the end
            return dict(costs=costs, Rs=p.Rs, ts=p.ts, X=p.X, ms=ms,
                        all_reduce_ms=1e3 * sum(calls[:-1]) / CONFIG5_ITERS,
                        device=str(dba.mesh.device))
        finally:
            dist.destroy_process_group()

    rank_harness().report(queue, rank, run)


def nccl_probe_rank(rank: int, world: int, store: str, queue) -> None:
    """Whether NCCL takes `world` ranks on cuda:0: one all-reduce; reports
    (rank, "ok") or (rank, the error's first line)."""
    import os

    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")     # the ranks share one host
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        x = torch.ones(1, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out = "ok" if float(x) == world else f"sum {float(x)}"
        dist.destroy_process_group()
    except Exception as e:          # the outcome is the finding, not a failure
        out = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
    queue.put((rank, out))


@contextlib.contextmanager
def counted_all_reduces():
    """The calls of torch.distributed.all_reduce in the block: the host
    seconds each took (its enqueue with NCCL; with gloo on CUDA tensors its
    wait for the copies through the host and the exchange)."""
    import torch.distributed as dist

    real, calls = dist.all_reduce, []

    def counting(*a, **k):
        t = time.perf_counter()
        out = real(*a, **k)
        calls.append(time.perf_counter() - t)
        return out

    dist.all_reduce = counting
    try:
        yield calls
    finally:
        dist.all_reduce = real


def ba_rms(params, obs, K, dev) -> float:
    """Mean reprojection error (px) of params on the card."""
    from sift_pyocl_tpu_torch.ops import as_tensor
    from sift_pyocl_tpu_torch.sfm.ba import BAObs, BAParams, residuals

    p = BAParams(*(as_tensor(np.asarray(a), dev, torch.float32) for a in params))
    o = BAObs(*(as_tensor(np.asarray(a), dev) for a in obs))
    return float(residuals(p, o, as_tensor(K, dev, torch.float32)).norm(dim=1).mean())


def check_costs(tag: str, costs, ref, rtol_each: float) -> float:
    """The first cost within rtol 1e-5 of the reference's and the last
    within 5 % (the outer bounds), and every iteration's within
    `rtol_each`; returns the largest relative difference."""
    assert len(costs) == len(ref) == CONFIG5_ITERS, (tag, len(costs), len(ref))
    assert np.isfinite(costs).all(), (tag, costs)
    assert abs(costs[0] - ref[0]) <= 1e-5 * abs(ref[0]), (tag, costs[0], ref[0])
    assert abs(costs[-1] - ref[-1]) < 0.05 * ref[-1], (tag, costs[-1], ref[-1])
    worst = max(abs(c - r) / abs(r) for c, r in zip(costs, ref))
    assert worst <= rtol_each, (tag, worst, costs, ref)
    return worst


def check_config5(dev) -> dict:
    """Phase E1 and E2: config 5 through DistributedBA.  E1: an NCCL group
    of world size 1 in this process against run_ba on the same problem
    (first cost within rtol 1e-5, last within 5 %, every iteration's
    within E1_RTOL_EACH, the reprojection error falling), 34 all-reduces
    an iteration; ms a warm LM iteration, the host's ms in all_reduce, host
    syncs and device ms an iteration.  E2: two spawned ranks on cuda:0
    over gloo (NCCL takes one rank a card: probed first, and reported),
    both ranks' costs and results identical, their costs against E1's
    (the same outer bounds, every iteration's within E2_RTOL_EACH); ms a
    warm iteration and the host's ms in all_reduce."""
    import tempfile

    import torch.distributed as dist

    from sift_pyocl_tpu_torch.parallel import global_ba_mesh
    from sift_pyocl_tpu_torch.sfm import DistributedBA, run_ba

    K, gt, start, obs = config5_problem()
    report = {"observations": int((obs.w > 0).sum()), "cameras": CONFIG5["n_cams"],
              "points": CONFIG5["n_points"], "iters": CONFIG5_ITERS}
    rms0 = ba_rms(start, obs, K, dev)
    _, ref = run_ba(start, obs, K, iters=CONFIG5_ITERS, device=dev)
    report["run_ba_ms_per_iter"] = lm_ms(lambda *a, **k: run_ba(*a, device=dev, **k),
                                         start, obs, K)
    store = tempfile.mkdtemp(prefix="config5_")

    # E1: NCCL, world size 1, in this process
    dist.init_process_group("nccl", init_method=f"file://{store}/e1", world_size=1, rank=0)
    try:
        mesh = global_ba_mesh()
        assert mesh.size == 1 and mesh.group is not None and mesh.device == dev, mesh
        dba = DistributedBA(mesh)
        with counted_all_reduces() as calls:
            p1, costs1 = dba.run(start, obs, K, iters=CONFIG5_ITERS)
        # one more all-reduce a run: the point blocks gathered at the end
        per_iter = (len(calls) - 1) / CONFIG5_ITERS
        assert per_iter == 4 + CONFIG5_CG, f"{per_iter} all-reduces an LM iteration"
        e1_err = check_costs("E1", costs1, ref, E1_RTOL_EACH)
        rms1 = ba_rms(p1, obs, K, dev)
        assert rms1 < rms0, (rms0, rms1)
        ms1 = lm_ms(dba.run, start, obs, K)
        # the host's time in all_reduce on a warm run: the first run above
        # also holds NCCL's communicator set-up, made at the first collective
        with counted_all_reduces() as warm:
            dba.run(start, obs, K, iters=CONFIG5_ITERS)
        assert len(warm) == len(calls), (len(warm), len(calls))
        syncs = [len(host_syncs(lambda: dba.run(start, obs, K, iters=n))) for n in (1, 3)]
        # an iteration's kernels: a 3-iteration run less a 1-iteration run
        events = [cuda_events(lambda: dba.run(start, obs, K, iters=n), calls=1) for n in (1, 3)]
    finally:
        dist.destroy_process_group()
    by_name = {}
    for sign, evs in zip((-0.5, 0.5), events):
        for e in evs:
            n, ms = by_name.get(e.name, (0.0, 0.0))
            by_name[e.name] = (n + sign, ms + sign * e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    report.update(first_cost=costs1[0], last_cost=costs1[-1], run_ba_first_cost=ref[0],
                  run_ba_last_cost=ref[-1], rms_start=rms0, rms_end=rms1,
                  e1_cost_rel_err_max=e1_err, all_reduces_per_iter=per_iter,
                  e1_ms_per_iter=ms1,
                  e1_all_reduce_host_ms_per_iter=1e3 * sum(warm[:-1]) / CONFIG5_ITERS,
                  e1_host_syncs_per_iter=(syncs[1] - syncs[0]) / 2,
                  e1_launches_per_iter=sum(n for n, _ in by_name.values()),
                  e1_device_ms_per_iter=sum(ms for _, ms in by_name.values()),
                  e1_top_kernels=[[name[:80], n, ms] for name, (n, ms) in top])
    print(f"[config5] E1 (NCCL, world size 1): {report['observations']} observations; costs "
          f"{costs1[0]:.6g} -> {costs1[-1]:.6g} (run_ba {ref[0]:.6g} -> {ref[-1]:.6g}); "
          f"reprojection {rms0:.4f} -> {rms1:.4f} px; {ms1:.3f} ms a warm LM iteration "
          f"(run_ba {report['run_ba_ms_per_iter']:.3f}), of which "
          f"{report['e1_all_reduce_host_ms_per_iter']:.3f} ms in the host's all_reduce "
          f"calls; every cost within {e1_err:.3g} of run_ba's; {per_iter:g} all-reduces, "
          f"{report['e1_host_syncs_per_iter']:g} host syncs, "
          f"{report['e1_launches_per_iter']:g} CUDA launches and "
          f"{report['e1_device_ms_per_iter']:.3f} device ms an iteration", flush=True)
    for name, n, ms in report["e1_top_kernels"]:
        print(f"[config5]   {ms:8.3f} device ms, {n:6.1f} launches an iteration: {name}")

    # E2: two ranks on cuda:0; which backend takes them
    spawn_ranks = rank_harness().spawn_ranks
    probe = spawn_ranks(nccl_probe_rank, lambda r: (CONFIG5_RANKS, f"{store}/probe"),
                        CONFIG5_RANKS, RANK_TIMEOUT_S)
    report["nccl_two_ranks_one_card"] = probe[0]
    print(f"[config5] NCCL with {CONFIG5_RANKS} ranks on cuda:0: {probe}", flush=True)
    res = spawn_ranks(config5_rank, lambda r: (CONFIG5_RANKS, f"{store}/e2", "gloo"),
                      CONFIG5_RANKS, RANK_TIMEOUT_S)
    a = res[0]
    for r in range(1, CONFIG5_RANKS):
        b = res[r]
        assert a["costs"] == b["costs"], "the ranks' costs differ"
        for key in ("Rs", "ts", "X"):
            assert np.array_equal(a[key], b[key]), f"the ranks' {key} differ"
    assert {v["device"] for v in res.values()} == {str(dev)}, res
    e2_err = check_costs("E2", a["costs"], costs1, E2_RTOL_EACH)
    rms2 = ba_rms((a["Rs"], a["ts"], a["X"]), obs, K, dev)
    assert rms2 < rms0, (rms0, rms2)
    report.update(e2_backend="gloo", e2_first_cost=a["costs"][0], e2_last_cost=a["costs"][-1],
                  e2_cost_rel_err_max=e2_err,
                  e2_rms_end=rms2, e2_ms_per_iter=max(v["ms"] for v in res.values()),
                  e2_all_reduce_host_ms_per_iter=max(v["all_reduce_ms"] for v in res.values()))
    print(f"[config5] E2 ({CONFIG5_RANKS} ranks on {dev}, gloo): ranks identical; costs "
          f"{a['costs'][0]:.6g} -> {a['costs'][-1]:.6g}, every cost within {e2_err:.3g} of "
          f"E1's; reprojection {rms2:.4f} px; "
          f"{report['e2_ms_per_iter']:.3f} ms a warm LM iteration, of which "
          f"{report['e2_all_reduce_host_ms_per_iter']:.3f} ms in the host's all_reduce "
          "calls", flush=True)
    return report


def check_spatial(x: torch.Tensor, dev) -> dict:
    """Phase E3: sharded_scale_space of the 1080x1920 frame on (cuda:0,) x
    2 and x 4 against the plain single-device pyramid: blurs within 2e-3,
    DoGs within 4e-3, every shard on its device; ms a call beside the plain
    pyramid's."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
    from sift_pyocl_tpu_torch.parallel import join_rows, make_frames_mesh, sharded_scale_space

    cfg = SiftConfig()
    plain = build_scale_space(x, cfg, plain=True)
    report = {"plain_pyramid_ms": host_ms(lambda: build_scale_space(x, cfg, plain=True))}
    for n, n_oct in SPATIAL_SHARDS.items():
        mesh = make_frames_mesh(devices=[dev] * n, axis="rows")
        octs = sharded_scale_space(x, cfg, mesh)
        assert len(octs) == n_oct, (n, len(octs))
        err_b = err_d = 0.0
        for o, (blurs, dogs) in enumerate(octs):
            assert len(blurs) == len(dogs) == n and all(s.device == dev for s in blurs + dogs)
            err_b = max(err_b, float((join_rows(blurs) - plain[o][0]).abs().max()))
            err_d = max(err_d, float((join_rows(dogs) - plain[o][1]).abs().max()))
        assert err_b <= 2e-3 and err_d <= 4e-3, (n, err_b, err_d)
        ms = host_ms(lambda: sharded_scale_space(x, cfg, mesh))
        report[f"shards_{n}"] = dict(octaves=n_oct, ms=ms, max_err_blurs=err_b,
                                     max_err_dogs=err_d)
        print(f"[config5] E3 sharded_scale_space 1080x1920 on {n} shards of {dev}: {n_oct} "
              f"octaves, blurs within {err_b:.2e}, DoGs within {err_d:.2e} of the plain "
              f"pyramid; {ms:.3f} ms a call (plain, 7 octaves: "
              f"{report['plain_pyramid_ms']:.3f})", flush=True)
    return report


# Phase F: the 200-frame VO fence (tests/test_vo_longrun.py's scene,
# settings and bounds, held in utils/longrun.py) on the card.  Device memory
# may not grow after frame 2 by more than FENCE_MEM_SLACK.
FENCE_MEM_SLACK = 1 << 20


@contextlib.contextmanager
def eager_vo_steps():
    """vo_step as its eager form for the fence and the CLI (the references
    of their runs through the graph)."""
    from sift_pyocl_tpu_torch.models import vo as vo_mod
    from sift_pyocl_tpu_torch.utils import longrun

    saved = vo_mod.vo_step, longrun.vo_step
    vo_mod.vo_step = longrun.vo_step = vo_mod._vo_step_eager
    try:
        yield
    finally:
        vo_mod.vo_step, longrun.vo_step = saved


def check_fence(dev) -> dict:
    """Phase F: vo_init + 199 vo_step on the 224x224 fence on the card with
    the hand-written kernels, through vo_step's graph (captured at the first
    step), then again with the eager step.  Gates: the reference test's
    asserts (finite t, lam and map every 25 frames, tracked >= 0.95, 0.45 <
    path ratio < 2.5, ATE < 0.35, RSS growth < 500 MB), no kernel library
    built or loaded and no carried-state shape changed after frame 2,
    memory_allocated after the last step at most FENCE_MEM_SLACK above its
    value after frame 2; one capture, the step's body run twice (its
    warm-up and capture: K1-K6 three times with vo_init's, K7 four times);
    a replayed step's launches of each kernel once, K7's twice
    (torch.profiler); tracked, ATE and path ratio equal to the eager run's.
    Prints ms per warm step (host clock, synchronised, median) of both runs,
    tracked, ATE, path ratio and max_memory_allocated."""
    from sift_pyocl_tpu_torch import vo_step
    from sift_pyocl_tpu_torch.models.vo import STEP_GRAPHS
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sift_pyocl_tpu_torch.utils import longrun, profiling

    t = time.perf_counter()
    frames = longrun.render_frames()
    render_s = time.perf_counter() - t
    last = longrun.N_FRAMES - 1
    mem, kept = {}, {}

    def after_step(i, st, out):
        if i in (longrun.WARM, last):
            mem[i] = torch.cuda.memory_allocated(dev)
        if i == last:
            kept["state"] = st

    STEP_GRAPHS.clear()             # the memory figures are the fence's own
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    captures = STEP_GRAPHS.captures
    r = longrun.run(dev, frames, after_step)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = 1e3 * float(np.median(r["step_s"][longrun.WARM:]))
    growth = mem[last] - mem[longrun.WARM]
    print(f"[fence] {r['frames']} frames {longrun.SHAPE} on {dev} (rendered in {render_s:.1f} s): "
          f"tracked {r['tracked']:.3f}, ATE {r['ate']:.4f}, path ratio {r['path_ratio']:.3f}, "
          f"{step_ms:.3f} ms a warm replayed step (host clock, synchronised, median; min "
          f"{1e3 * min(r['step_s'][longrun.WARM:]):.3f}, max {1e3 * max(r['step_s'][longrun.WARM:]):.3f}), "
          f"memory_allocated {mem[longrun.WARM]} -> {mem[last]} B ({growth:+d}), "
          f"max_memory_allocated {peak} B, RSS growth {r['rss_growth_mb']:.1f} MB", flush=True)
    print("[fence] launch counts (vo_init, the graph's warm-up and capture):", counts, flush=True)
    assert r["frames"] == longrun.N_FRAMES
    assert not r["not_finite"], f"t, lam or the map not finite at frames {r['not_finite']}"
    assert r["tracked"] >= longrun.TRACKED, f"tracked only {r['tracked']:.3f}"
    assert r["centres_finite"]
    lo, hi = longrun.PATH_RATIO
    assert lo < r["path_ratio"] < hi, f"path ratio {r['path_ratio']:.3f}"
    assert r["ate"] < longrun.ATE, f"long-run ATE {r['ate']:.4f}"
    assert not r["reshaped"], f"carried state changed shape at frames {r['reshaped']}"
    assert not r["rebuilt"], f"kernel library built or loaded at frames {r['rebuilt']}"
    assert r["rss_growth_mb"] < longrun.RSS_MB, f"RSS grew {r['rss_growth_mb']:.0f} MB"
    assert growth <= FENCE_MEM_SLACK, f"device memory grew {growth} B after frame 2"
    assert STEP_GRAPHS.captures == captures + 1, "the fence captured more than one graph"
    for name, n in counts.items():
        want = (1 + GRAPH_BODIES if name in FRONTEND else 2 * GRAPH_BODIES
                if name == "best2_l2" else 0)
        assert n == want, f"fence: {name} launched {n} times (want {want})"

    def replay():
        vo_step(kept["state"], frames[last], longrun.K, longrun.CFG, longrun.VO)

    prof = profiling.device_profile(replay, 1, sessions=2)
    got = check_kernel_launches("fence", prof.pop("launches_by_name_per_frame"), STEP_LAUNCHES)
    print(f"[fence] a replayed step: CUDA launches {prof['kernel_launches_per_frame']:.0f}, "
          f"device ms {prof['kernel_ms_per_frame']:.3f}, of the hand-written kernels {got}; top "
          f"ops {json.dumps([[n, round(ms, 4)] for n, ms in prof['top_kernels_ms_per_frame'][:6]])}",
          flush=True)
    with eager_vo_steps():
        e = longrun.run(dev, frames)
    eager_ms = 1e3 * float(np.median(e["step_s"][longrun.WARM:]))
    print(f"[fence] eager run: tracked {e['tracked']:.3f}, ATE {e['ate']:.4f}, path ratio "
          f"{e['path_ratio']:.3f}, {eager_ms:.3f} ms a warm step (median)  [{nvidia_smi_line()}]",
          flush=True)
    for k in ("tracked", "ate", "path_ratio"):
        assert r[k] == e[k], f"fence: {k} {r[k]} through the graph, {e[k]} eager"
    return {"frames": r["frames"], "render_s": render_s, "tracked": r["tracked"],
            "ate": r["ate"], "path_ratio": r["path_ratio"], "step_ms_median": step_ms,
            "eager_step_ms_median": eager_ms, "replay_device_ms": prof["kernel_ms_per_frame"],
            "replay_launches": prof["kernel_launches_per_frame"],
            "memory_allocated": [mem[longrun.WARM], mem[last]], "max_memory_allocated": peak,
            "rss_growth_mb": r["rss_growth_mb"], "launch_counts": counts}


# Phase G: BASELINE config 2, pairwise 1080p matching, as
# tools/bench_configs.py's config2_pairwise, config2_sequence and
# config2_stages run it: SiftConfig(), detect_and_describe, the L2 ratio
# match at 0.5329^2 (match_descriptors_dense) and RANSAC-H.  The pair's
# second frame is the first flipped top to bottom, as there; SIFT is not
# mirror-invariant, so its inliers are printed, not gated.  The JAX tool's
# sequence frames differ by a tiny intensity change, which leaves nothing
# to check the fitted H against; here the sequence is crops of a larger
# scene moving by CONFIG2_STEP a frame (like phase A's), so every fitted H
# is held to that known translation.  The corner bound was to be 1 px; on
# an H100 the fitted H moved a corner by up to 3.00 px (kernels) and 3.49
# px (plain=True on the same frames): RANSAC-H's f32 DLT fit
# of ~1140 inliers leaves perspective terms that shift the corners of a
# 1920-px frame by pixels, while a float64 fit of the same inliers lands
# within 0.07 px, and the inliers sit a median 0.066-0.070 px from the
# translation.  So the corner bound is set from the plain run (4 px) and
# the inliers' median distance from the translation is gated as well.
CONFIG2_RATIO_SQ = 0.5329 ** 2
CONFIG2_SEQ_FRAMES = 8
CONFIG2_STEP = (3, -4)          # (dy, dx) of the crop origin a frame
CONFIG2_CORNER_PX = 4.0         # the four image corners mapped within this
CONFIG2_INLIER_PX = 0.2         # inliers' median distance from the translation
CONFIG2_MIN_INLIERS = 100       # inliers a frame of the sequence


def config2_match_fit(b1, b2, seed: int, weights=None, plain: bool = False):
    """config2_pairwise's step after detection: b1's slots ratio-matched to
    b2's (L2, CONFIG2_RATIO_SQ; K7 unless plain) and RANSAC-H on the kept
    pairs (``weights``: the hypotheses' rows, else drawn from `seed`).
    Returns (keep, idx2, dist, dist2, RansacResult)."""
    from sift_pyocl_tpu_torch.ops.match import match_descriptors_dense
    from sift_pyocl_tpu_torch.sfm.ransac import ransac_homography

    keep, mid, d, d2 = match_descriptors_dense(b1.desc, b1.valid, b2.desc, b2.valid,
                                               metric="L2", ratio_sq=CONFIG2_RATIO_SQ,
                                               plain=plain)
    uv1 = torch.stack([b1.x, b1.y], -1)
    uv2 = torch.stack([b2.x, b2.y], -1)[mid.long()]
    return keep, mid, d, d2, ransac_homography(seed, uv1, uv2, keep, weights=weights)


def corner_error(H, shape, dy: float, dx: float) -> float:
    """Largest distance between the four image corners mapped by H and the
    corners moved by (dx, dy)."""
    h, w = shape
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64)
    m = c @ np.asarray(H, np.float64).T
    return float(np.linalg.norm(m[:, :2] / m[:, 2:] - (c[:, :2] + [dx, dy]), axis=1).max())


def check_config2(dev) -> dict:
    """Phase G: config 2 at 1080x1920 on the card.  pair: both frames
    detected, matched and fitted (K1-K6 twice, K7 once); its match and fit
    on the same buffers equal, bit for bit, to the plain match's (keep,
    indices and distances of the valid rows, the same inliers given the
    same rows), and its plain=True detection held to the kernel path's
    keypoints as phase 1 holds them.  seq: CONFIG2_SEQ_FRAMES crops moving
    by CONFIG2_STEP, each detected once and matched and fitted against the
    previous frame's buffer on the card: every H within CONFIG2_CORNER_PX of
    the translation at the corners, its inliers a median CONFIG2_INLIER_PX
    from it, >= CONFIG2_MIN_INLIERS inliers, K1-K6 once a detection and K7
    once a match.  stages: detect, match and RANSAC-H, each its host ms,
    CUDA launches and device ms."""
    from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sift_pyocl_tpu_torch.ops.match import match_descriptors_dense
    from sift_pyocl_tpu_torch.sfm.ransac import _sample_weights, ransac_homography
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets, synthetic_scene

    cfg = SiftConfig()
    report = {}
    c = torch.from_numpy(synthetic_scene(SHAPE, n_blobs=200, seed=0)).to(dev)

    def pair():
        b1 = detect_and_describe(c, cfg)
        b2 = detect_and_describe(c.flip(0), cfg)
        return b1, b2, config2_match_fit(b1, b2, 0)

    pair()
    torch.cuda.synchronize()
    reset_launch_counts()
    b1, b2, (keep, mid, d, d2, res) = pair()
    counts = launch_counts()
    for name in FRONTEND:
        assert counts[name] == 2, f"config2 pair: {name} launched {counts[name]} times"
    assert counts["best2_l2"] == 1, f"config2 pair: K7 launched {counts['best2_l2']} times"
    n_kp = [int(b.valid.sum()) for b in (b1, b2)]
    pair_ms = host_ms(pair)
    # the same buffers through the plain match, the same RANSAC rows
    rows = _sample_weights(0, keep, 256, 4)
    got = config2_match_fit(b1, b2, 0, weights=rows)
    want = config2_match_fit(b1, b2, 0, weights=rows, plain=True)
    v = b1.valid
    assert torch.equal(got[0], want[0]), "config2 pair: keep differs from the plain match"
    for name, a, b in (("idx2", got[1], want[1]), ("dist", got[2], want[2]),
                       ("dist2", got[3], want[3])):
        assert torch.equal(a[v], b[v]), f"config2 pair: {name} differs from the plain match"
    assert torch.equal(got[4].inliers, want[4].inliers), "config2 pair: inliers differ"
    assert int(got[4].n_inliers) == int(want[4].n_inliers)
    plain_kp = [to_keypoint_records(detect_and_describe(x, cfg, plain=True))
                for x in (c, c.flip(0))]
    for kp_plain, b in zip(plain_kp, (b1, b2)):
        kp = to_keypoint_records(b)
        hits, l1 = match_keypoint_sets(kp_plain, kp)
        assert abs(len(kp) - len(kp_plain)) <= max(2, len(kp_plain) // 50)
        assert hits >= 0.98 * len(kp_plain) and l1 < 0.1, (hits, len(kp_plain), l1)
    report["pair"] = {"ms": pair_ms, "keypoints": n_kp, "matches": int(keep.sum()),
                      "inliers": int(res.n_inliers), "plain_inliers_same_rows":
                      int(want[4].n_inliers)}
    print(f"[config2] pair {SHAPE} (frame and its vertical flip): {n_kp} keypoints, "
          f"{int(keep.sum())} ratio matches, {int(res.n_inliers)} RANSAC-H inliers (printed, "
          f"not gated: SIFT is not mirror-invariant); {pair_ms:.3f} ms a pair (host clock, "
          f"synchronised); match and fit equal to the plain match's on the same buffers "
          f"({int(want[4].n_inliers)} inliers with the same rows)", flush=True)

    # seq: crops moving by CONFIG2_STEP, each detected once
    base = synthetic_scene(API_SCENE, n_blobs=200, seed=0)
    dy, dx = CONFIG2_STEP
    crops = [torch.from_numpy(api_crop(base, i * dy, i * dx)).to(dev)
             for i in range(CONFIG2_SEQ_FRAMES)]

    def seq():
        prev, out = detect_and_describe(crops[0], cfg), []
        for i in range(1, CONFIG2_SEQ_FRAMES):
            b = detect_and_describe(crops[i], cfg)
            out.append((b, prev, config2_match_fit(b, prev, i)))
            prev = b
        return out

    seq()
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    fits = seq()
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t
    counts = launch_counts()
    n = CONFIG2_SEQ_FRAMES
    for name in FRONTEND:
        assert counts[name] == n, f"config2 seq: {name} launched {counts[name]} times"
    assert counts["best2_l2"] == n - 1, f"config2 seq: K7 launched {counts['best2_l2']} times"
    errs = [corner_error(f[4].model.cpu().numpy(), SHAPE, dy, dx) for _, _, f in fits]
    inl = [int(f[4].n_inliers) for _, _, f in fits]
    med = []
    for b, prev, (_, mid_s, _, _, res_s) in fits:
        moved = torch.stack([prev.x, prev.y], -1)[mid_s.long()] - torch.stack([b.x, b.y], -1)
        d_s = (moved - torch.tensor([dx, dy], dtype=moved.dtype, device=dev)).norm(dim=1)
        med.append(float(d_s[res_s.inliers].median()))
    seq_ms = 1e3 * seq_s / n
    print(f"[config2] seq: {n} crops moving ({dy}, {dx}) a frame, each detected once and "
          f"matched to the previous: inliers {inl}, corner error (px) "
          f"{[round(e, 4) for e in errs]}, inliers' median distance from the translation "
          f"(px) {[round(m, 4) for m in med]}; {seq_ms:.3f} ms a frame (host clock, "
          f"synchronised, first frame's detection included)", flush=True)
    assert max(errs) < CONFIG2_CORNER_PX, f"config2 seq: corner error {max(errs)} px"
    assert max(med) < CONFIG2_INLIER_PX, f"config2 seq: inliers {max(med)} px off"
    assert min(inl) >= CONFIG2_MIN_INLIERS, f"config2 seq: {min(inl)} inliers"
    report["seq"] = {"frames": n, "ms_per_frame": seq_ms, "inliers": inl,
                     "corner_err_px": errs, "inlier_median_px": med}

    # stages on the pair's full-size buffers
    uv1 = torch.stack([b1.x, b1.y], -1)
    uv2m = torch.stack([b2.x, b2.y], -1)[mid.long()]
    stages = {}
    for name, fn in (
            ("detect", lambda: detect_and_describe(c, cfg)),
            ("match", lambda: match_descriptors_dense(b1.desc, b1.valid, b2.desc, b2.valid,
                                                      metric="L2", ratio_sq=CONFIG2_RATIO_SQ)),
            ("ransac_h256", lambda: ransac_homography(0, uv1, uv2m, keep)),
            ("ransac_h64", lambda: ransac_homography(0, uv1, uv2m, keep, n_hypo=64))):
        launches, dev_ms = profile_calls(fn)
        stages[name] = {"ms": host_ms(fn), "cuda_launches": launches, "device_ms": dev_ms}
    report["stages"] = stages
    report["slots"] = int(b1.desc.shape[0])
    print(f"[config2] stages ({report['slots']} slots, {int(keep.sum())} matches): "
          f"{ {k: {m: round(x, 4) for m, x in r.items()} for k, r in stages.items()} }",
          flush=True)
    print("config2:", json.dumps(report), flush=True)
    return report


# Phase H: the evaluate CLI (python -m sift_pyocl_tpu_torch.evaluate) on the
# card, over config 4's 50 frames written as PGM files and a TUM file, read
# through the native loader.  sfm bound: phase C's 0.05 on the in-memory
# frames plus the u8 quantisation allowance tests/test_evaluate_cli.py
# grants (0.15 against its float test's 0.08).  vo bound: twice the JAX
# package's VO ATE on the same files (0.084778, run once on the CPU by
# tools/jax_cpu_references.py; its sfm mode gave 0.015747).
CLI_SFM_ATE = 0.05 + (0.15 - 0.08)
CLI_VO_JAX_ATE = 0.084778
CLI_VO_ATE = 2 * CLI_VO_JAX_ATE


def check_evaluate_cli(dev, seq) -> dict:
    """Phase H: save_sequence writes config 4's frames and truth into a
    temporary directory; evaluate.main runs over them in sfm and in vo
    mode on the card (vo: through vo_step's graph; sfm: through the
    detector's and the registration's), then in both modes with the eager
    functions.  Gates: rc 0, the JSON line's keys, the frames read by the
    native loader (FrameSource.backend), 50 of 50 registered in sfm mode,
    ATE below CLI_SFM_ATE / CLI_VO_ATE, each eager line equal to the
    replayed one.  Prints each run's wall time."""
    import io
    import tempfile

    from sift_pyocl_tpu_torch import evaluate
    from sift_pyocl_tpu_torch.utils import framesource

    K, frames, gtR, gtT, _ = seq
    backends = []

    class RecordedSource(framesource.FrameSource):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            backends.append(self.backend)

    report = {}
    with tempfile.TemporaryDirectory(prefix="evaluate_cli_") as tmp:
        seq_dir, gt = evaluate.save_sequence(tmp + "/seq", frames, gtR, gtT)
        orig = framesource.FrameSource
        framesource.FrameSource = RecordedSource
        try:
            for mode, bound in (("sfm", CLI_SFM_ATE), ("vo", CLI_VO_ATE)):
                buf = io.StringIO()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = evaluate.main(["--frames", str(seq_dir), "--gt", str(gt), "--mode", mode,
                                        "--fx", str(float(K[0, 0])), "--device", str(dev)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                line = json.loads(buf.getvalue().strip().splitlines()[-1])
                print(f"[evaluate] --mode {mode}: rc {rc}, {line}, {wall:.3f} s "
                      f"({wall / len(frames):.4f} s/frame, frame loading included); "
                      f"FrameSource backend {backends[-1]}; bound {bound:.4f}", flush=True)
                assert rc == 0, (mode, line)
                assert set(line) == {"ate_rmse", "n_frames", "n_registered", "mode", "shape"}
                assert backends[-1] == "native", backends
                assert line["n_frames"] == len(frames) and line["mode"] == mode
                if mode == "sfm":
                    assert line["n_registered"] == len(frames), line
                assert line["ate_rmse"] < bound, (mode, line)
                report[mode] = {**line, "wall_s": wall}
            # vo mode went through vo_step's graph, sfm mode through the
            # detector's and the registration's: the eager functions on the
            # same files give the same trajectory
            for mode, eager in (("vo", eager_vo_steps), ("sfm", eager_programs)):
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf), eager():
                    rc = evaluate.main(["--frames", str(seq_dir), "--gt", str(gt), "--mode",
                                        mode, "--fx", str(float(K[0, 0])), "--device", str(dev)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                line = json.loads(buf.getvalue().strip().splitlines()[-1])
                print(f"[evaluate] --mode {mode} eager: rc {rc}, {line}, {wall:.3f} s "
                      f"({wall / len(frames):.4f} s/frame)  [{nvidia_smi_line()}]", flush=True)
                assert rc == 0 and line == {k: report[mode][k] for k in line}, \
                    (line, report[mode])
                report[mode]["eager_wall_s"] = wall
        finally:
            framesource.FrameSource = orig
    return report


def print_memory(after: str) -> None:
    """The card's memory after a phase: every graph keeps its own pool;
    each cache's keys and the memory its graphs' pools reserve; and the
    seconds since the script started (its time limit holds the whole
    run)."""
    from sift_pyocl_tpu_torch.models.sift import DETECT_GRAPHS
    from sift_pyocl_tpu_torch.models.vo import STEP_GRAPHS
    from sift_pyocl_tpu_torch.ops.match import MATCH_GRAPHS
    from sift_pyocl_tpu_torch.ops.transform import WARP_GRAPHS
    from sift_pyocl_tpu_torch.parallel.pipeline_octaves import STAGE0_GRAPHS, STAGE1_GRAPHS
    from sift_pyocl_tpu_torch.sfm import ba, pipeline, pnp, posegraph, twoview

    caches = {"vo_step": STEP_GRAPHS, "detector": DETECT_GRAPHS,
              "registration": pipeline.REGISTER_GRAPHS, "ransac_pnp": pnp.PNP_GRAPHS,
              "pair": pipeline.PAIR_GRAPHS, "lm": ba.LM_GRAPHS,
              "posegraph": posegraph.POSEGRAPH_GRAPHS, "boot_probe": pipeline.BOOT_PROBE_GRAPHS,
              "loop_probe": pipeline.LOOP_PROBE_GRAPHS, "two_view": twoview.TWOVIEW_GRAPHS,
              "match": MATCH_GRAPHS,
              "warp": WARP_GRAPHS, "stage0": STAGE0_GRAPHS, "stage1": STAGE1_GRAPHS}
    by_pool = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id") or ())
        by_pool[pool] = by_pool.get(pool, 0) + seg["total_size"]
    held = {}
    for name, c in caches.items():
        pool = sum(by_pool.get(tuple(g.graph.pool()), 0) for g in c._graphs.values())
        held[name] = f"{len(c)} keys, {pool / 2**20:.0f} MiB"
    print(f"[memory] after {after} ({time.perf_counter() - STARTED:.1f} s into the run): "
          f"reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB, "
          f"allocated {torch.cuda.memory_allocated() / 2**20:.0f} MiB; graphs held (their "
          f"pools) {held}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from sift_pyocl_tpu_torch import SLICE_CONFIG, SiftConfig, detect_and_describe
    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    img = synthetic_scene(SHAPE, seed=0)
    x = torch.from_numpy(img).to(dev)
    rec = Kernels()
    check_ladders(x, SiftConfig(), rec)
    check_keypoint_kernels(x, SLICE_CONFIG, rec)
    check_mask_kernels(x, SiftConfig(), rec)
    check_matcher(detect_and_describe(x, SiftConfig()), rec)
    check_blur(x, rec)
    check_slice_frontend(img, x, dev)
    base = check_vo(dev, rec.rows["refine_multi"]["decode_cuda_launches"])
    p1 = check_vo_k8(base)
    p2 = check_per_octave(img, dev)
    check_buckets(img, x, dev)
    p4 = check_scales2(img, x, dev)
    p5 = check_split_windows(x, rec)
    check_plain_keypoints(img, dev)
    check_fused_masks(x, rec)
    p7 = check_vo_fused(base, p1)
    check_fused_scales2(img, x, dev)
    p8 = check_matcher_f32(base["bufs"], rec)
    check_linalg_kernels(dev, rec)
    print_memory("kernels, P1-P8 and the VO paths")
    check_api_align(dev)
    print_memory("phase A")
    check_invariance(dev)
    print_memory("phase B")
    seq4 = config4_sequence()
    c4 = check_sfm(dev, seq4)
    print_memory("phase C")
    p_d = check_batched(dev)
    print_memory("phase D")
    print("config5:", json.dumps({**check_config5(dev), **check_spatial(x, dev)}), flush=True)
    print_memory("phase E")
    print("fence:", json.dumps(check_fence(dev)), flush=True)
    print_memory("phase F")
    check_config2(dev)
    print_memory("phase G")
    print("evaluate:", json.dumps(check_evaluate_cli(dev, seq4)), flush=True)
    print_memory("phase H")

    # each kernel's wrapper calls on its path.  On the VO paths (the main
    # path for K1-K7, P1 for K8, P7 for K1m/K2m) the steps replay a graph,
    # which runs no Python: their launches are the VO_STEPS replayed steps'
    # calls, read from a replayed step's device profile, and
    # capture_launches the wrappers' counters over the graph's warm-up and
    # capture.  P2 (FRAMES frames) for K10a/K10b and P4 (FRAMES frames)
    # for K9 replay SiftPlan's detector graph: their wrapper calls are read
    # from the replayed frames' device profiles (check_wrapper_launches).
    # The other paths count their wrappers: P5 (one frame) for K11a/K11b,
    # P8 (two f32 matches) for K7f.  K12/K13 run on phase C's bootstrap,
    # whose two-view inits replay a graph: the first replayed run's inits
    # times a replayed init's launches by kernel name, and capture_launches
    # the wrappers' counters over that run (its captures).
    graph_paths = {name: run for run, names in ((base, VO_KERNELS), (p1, ("extrema_masks",)),
                                                (p7, FUSED_LADDERS)) for name in names}
    counts = {name: VO_STEPS * graph_path_calls(name, run["replay_launches"])
              for name, run in graph_paths.items()}
    counts.update({"compact_mask": p2["compact_mask"], "refine_octave": p2["refine_octave"],
                   "separable_blur": p4["separable_blur"],
                   "orientation_hist": p5["orientation_hist"],
                   "descriptor_hist": p5["descriptor_hist"], "best2_l2_f32": p8["best2_l2_f32"],
                   **c4["two_view"]["launches"]})
    # and on phase D: K3-K6 at B = 8 (one batch), K8 at B = 4 with "pallas"
    config3 = {**p_d["batches"][8]["counts"], "extrema_masks": p_d["pallas_b4"]["extrema_masks"]}
    kernels = []
    for name, row in rec.rows.items():
        row["launches"] = counts[name]
        if name in graph_paths:
            row["capture_launches"] = graph_paths[name]["counts"][name]
            assert row["capture_launches"] > 0, f"{name}'s wrapper never ran on its path"
        if name in TWOVIEW_KERNELS:
            row["capture_launches"] = c4["two_view"]["capture_launches"][name]
        if name in ("compact_masks_multi", "refine_multi", "grad_atlas", "orient_desc_fused",
                    "extrema_masks"):
            row["config3_launches"] = config3[name]
        assert row["launches"] > 0, f"{name} was not launched on its path"
        kernels.append(row)
    assert len(kernels) == 18, f"{len(kernels)} kernel records"
    print(nvidia_smi_line(), flush=True)        # again, so the output's tail names the card
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

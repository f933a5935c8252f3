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
   in their tests.  Times each with CUDA
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
   frames (the first slice's path, plain pyramid) with every launch counter
   reset just before, and holds its keypoints to the plain-version path.
5. The main path: vo_init + 10 vo_step at 1080x1920 with SiftConfig() and
   VOConfig(), counters reset just before and read just after; every frame
   tracked with enough matches and a finite pose, K1-K6 launched once and K7
   twice a frame; the same run with plain=True agrees (keypoint counts,
   tracking, final camera centre, rotation).  Prints ms per step, the stage
   split, device time and launches per step, and host syncs per step; gates
   the per-step CUDA launches of K1's, K2's, K3's, K4's, K6's and K7's
   kernels and K8's (STEP_LAUNCHES, from torch.profiler; P1 and P7
   likewise), and each path's total at least the plain decode's launches
   (measured in step 3) below that of the host-decode design
   (LAUNCHES_BEFORE).
6. P1: the same VO run with SiftConfig(mask_backend="pallas"): K8 once,
   K1-K6 once and K7 twice a step, every frame's keypoint buffer equal to
   the default run's and the final pose within 1e-6 of it; ms per step,
   stage split, device time and launches beside the default mask's.
7. P2: SiftPlan.keypoints with kp_multi_launch=False: K10a, K10b and K6
   launched once per octave a frame, K3-K5 never; its keypoint buffer equal,
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
   keypoints.
11. P6: SiftPlan.keypoints with kp_backend="xla" (plain PyTorch after the
   K1/K2 pyramid), held to the kernel path's keypoints.
12. K1m/K2m (the mask forms of K1/K2, SiftConfig(mask_backend="fused")) on
   the 1080x1920 frame: blurs and DoGs bit-equal to K1's and K2's, masks
   bit-equal to K8's and to the plain stencil's on those DoGs, all 7
   octaves; against their plain versions (plain ladder + stencil) the
   stacks within 1e-3 and no mask pixel different away from a decision;
   K2m one CUDA launch a call and K1m at most 7; timed and profiled beside
   K1 + K8, K2 + K8 and the plain versions.
13. P7: the main path with SiftConfig(mask_backend="fused"): K1m and K2m
   once a step (their kernels gated per step: K2m's one cooperative
   launch, K1m's six level launches and one mask launch), K1, K2 and
   K8 never, the plain stencil never called, K3-K6
   once and K7 twice a step, every frame's keypoint buffer equal to the
   default run's, final pose within 1e-6; ms per step in turns (default,
   fused, fused, default), stage split and device time beside P1's and the
   default's.
14. SiftPlan.keypoints with SiftConfig(mask_backend="fused", scales=2):
   octave 0 through K9 and the stencil (the fused mask's None fallback),
   octaves >= 1 through K2m; buffer equal to scales=2 without fusion,
   keypoints held to its plain=True run.
15. P8: K7f (f32 operands) through match_descriptors_dense at the VO map
   call's shapes (one frame's 8320 slots against a 2048-slot map from
   another frame): descriptors /512 (exact sums) and /255 (rounded sums),
   d1/d2 within a stated tolerance of the plain version, i1 equal outside
   near-ties (counted); timed beside torch.mm + torch.topk.
16. Phase A, the reference library's API at 1080x1920 (frames: crops of
   the VO scene, the reference at (32, 32)): LinearAlign recovers a (-3,
   +5) translation (matrix within 0.02, offset within 0.3 px, interior
   median error < 2) and a 2 deg / 1.02x affine made with the port's warp;
   shift_only + double_check; relative over 4 frames drifting 2 px (within
   0.8 px); orsa (every returned match an inlier, < 9 px^2);
   MatchPlan(metric="L2") one K7 launch a match_index, indices equal to the
   CPU's; K1-K6 once per align call (counters reset just before it).
   Prints ms per warm align call (host image in, host result out) and its
   split (keypoints, match, fit, warp), the L1 matcher's launches and
   device time, and the host synchronisations of one call.
17. Phase B: the invariance battery (utils/invariance.py) through the port
   at 256x256: both scenes, all 9 cases against FLOORS, the double_im_size
   zoom fence and the angle fence.
18. Phase C: BASELINE config 4 (tools/bench_configs.py::config4_sfm's
   50-frame sequence, rendered from a seed) through IncrementalSfM, twice:
   50 of 50 frames registered, ATE < 0.05, map points within 20 % of 672,
   a loop edge, the two runs bit-equal in Rs, ts and points, K1-K6 once per
   frame detected, K7 never.  Prints wall time, s/frame and the phase
   split, one registered frame's CUDA launches, device ms and host
   synchronisations, and the BA's segment sum against float64.
19. Prints the card's nvidia-smi line again, a JSON line of per-kernel
   results (16 rows, launches from the path that runs each kernel,
   cuda_launches and device_ms a wrapper call from the profiler), then,
   as its last line, {"ok": true, "device": {...}}.

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
    `sessions` profiling sessions that recorded the most: a session now and
    then loses a record (a K3 run counted 4 launches in 5 calls of its one
    launch), and a lost record only ever lowers a count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    from sift_pyocl_tpu_torch.ops.kernels.window import _offsets, _valid_chunks, window_origin

    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    ar = torch.arange(win, device=fr.device)
    n_circle = n_square = n_union = 0
    for ks in _valid_chunks(valid, 256):
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


def plan_frames(plan, img, frames: int = FRAMES):
    """`frames` calls of plan.keypoints after one warm-up call (allocator,
    cuDNN algorithm choice), launch counters reset just before them.
    Returns (last records, host-clock ms per frame, launch counts)."""
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    plan.keypoints(img)
    torch.cuda.synchronize()
    reset_launch_counts()
    frame_ms = []
    for _ in range(frames):
        t = time.perf_counter()
        kp = plan.keypoints(img)
        frame_ms.append(1e3 * (time.perf_counter() - t))
    return kp, frame_ms, launch_counts()


def check_slice_frontend(img, x, dev) -> dict:
    """The first slice's path: SiftPlan.keypoints under SLICE_CONFIG."""
    from sift_pyocl_tpu_torch import SLICE_CONFIG, SiftPlan, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    cfg = SLICE_CONFIG
    kp, frame_ms, counts = plan_frames(SiftPlan(SHAPE, config=cfg, device=dev), img)
    print("SLICE_CONFIG launch counts over", FRAMES, "frames:", counts, flush=True)
    for name in ("compact_masks_multi", "refine_multi", "grad_atlas", "orient_desc_fused"):
        assert counts[name] == FRAMES, f"{name} launched {counts[name]} times in {FRAMES} frames"
    for name in ("octave0_ladder", "small_octaves_ladder", "best2_l2", "extrema_masks",
                 "separable_blur", "compact_mask", "refine_octave", "orientation_hist",
                 "descriptor_hist") + FUSED_LADDERS + ("best2_l2_f32",):
        assert counts[name] == 0, f"{name} launched {counts[name]} times"
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


def run_vo(imgs, K, cfg, vo, plain: bool, bufs=None):
    """vo_init + VO_STEPS vo_step; returns (state, outs, step ms, init
    counts).  With a list `bufs`, every frame's KeypointBuffer goes in it."""
    from sift_pyocl_tpu_torch import vo_init, vo_step
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    with frontend_recorder([] if bufs is None else bufs):
        reset_launch_counts()
        state = vo_init(imgs[0], K, cfg, vo, plain=plain)
        init_counts = launch_counts()
        torch.cuda.synchronize()
        reset_launch_counts()
        outs, ms = [], []
        for img in imgs[1:VO_STEPS + 1]:
            t = time.perf_counter()
            state, out = vo_step(state, img, K, cfg, vo, plain=plain)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            outs.append(out)
    return state, outs, ms, init_counts


def timed_vo_steps(imgs, K, cfg, vo):
    """vo_init + VO_STEPS vo_step; per step the wall ms (synchronised) and
    the host thread's CPU ms."""
    from sift_pyocl_tpu_torch import vo_init, vo_step

    state = vo_init(imgs[0], K, cfg, vo)
    torch.cuda.synchronize()
    wall, cpu = [], []
    for img in imgs[1:VO_STEPS + 1]:
        t, c = time.perf_counter(), time.thread_time()
        state, _ = vo_step(state, img, K, cfg, vo)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))
        cpu.append(1e3 * (time.thread_time() - c))
    return wall, cpu


VO_KERNELS = ("octave0_ladder", "small_octaves_ladder", "compact_masks_multi", "refine_multi",
              "grad_atlas", "orient_desc_fused", "best2_l2")


FUSED_LADDERS = ("octave0_ladder_mask", "small_octaves_ladder_mask")


def check_vo_counts(init_counts, counts, extra=(), ladders=VO_KERNELS[:2]):
    """The ladders (K1/K2, or `ladders`), K3-K6 (and `extra`) once in
    vo_init and once a step, K7 twice a step, every other kernel never."""
    on_path = tuple(ladders) + VO_KERNELS[2:] + tuple(extra)
    for name, n in init_counts.items():
        want = 1 if name in on_path and name != "best2_l2" else 0
        assert n == want, f"vo_init: {name} launched {n} times (want {want})"
    for name, n in counts.items():
        want = (2 if name == "best2_l2" else 1) * VO_STEPS if name in on_path else 0
        assert n == want, f"{name} launched {n} times in {VO_STEPS} steps (want {want})"


# Per-step CUDA launches of the redesigned kernels on a VO path (kernel name
# substrings in torch.profiler's trace): K2's one cooperative launch and
# K3's one launch, where the per-level design launched 35 level and downsample kernels
# (and a copy) for K2 and three kernels (and a fill) for K3; K1's six level
# launches; K6's one launch, where its wrapper launched 12 more; K7's one
# launch a call (map and keyframe), where its wrapper cast both valid masks
# first; K8's one launch on P1; K4's one launch, where its wrapper cast the
# valid mask and its caller decoded K3's output in ~100 small launches.  On
# P7, K2m is small_octaves_kernel_masks (one launch, was 41.6 a call), and
# K1m is K1's six level launches and one launch of K8's mask_kernel.
STEP_LAUNCHES = {"small_octaves_kernel": 1, "compact_kernel": 1,
                 "blur_level_kernel": 6, "orient_desc_kernel": 1, "best2_l2_kernel": 2,
                 "mask_kernel": 0, "refine_kernel": 1}
STEP_LAUNCHES_P1 = {**STEP_LAUNCHES, "mask_kernel": 1}
STEP_LAUNCHES_FUSED = {**STEP_LAUNCHES, "mask_kernel": 1}
# CUDA launches a step with the host-side decode before K4 (this script on
# an H100 at 1080x1920): the main path, P1 and P7 (2680 with K2m's earlier
# per-level design before that).
LAUNCHES_BEFORE = {"main path": 3548, "P1": 2639, "P7": 2639}


def check_step_launches(tag: str, prof: dict, want: dict, decode_launches: float) -> None:
    """Gate a VO path's per-step launches of each kernel in `want` (from the
    device profile of its warm steps), and its total: at least
    `decode_launches` (the plain decode's CUDA launches, measured in this
    run) below LAUNCHES_BEFORE[tag]."""
    by_name = prof.pop("launches_by_name_per_frame")
    got = {k: sum(n for name, n in by_name.items() if k in name) for k in want}
    total = prof["kernel_launches_per_frame"]
    print(f"{tag}: CUDA launches a step {total:.0f} (was {LAUNCHES_BEFORE[tag]}, the "
          f"decode alone {decode_launches:g}); of the redesigned kernels {got}", flush=True)
    assert got == want, f"{tag}: launches a step {got}, want {want}"
    assert total <= LAUNCHES_BEFORE[tag] - decode_launches, \
        f"{tag}: {total} CUDA launches a step, not {decode_launches} below {LAUNCHES_BEFORE[tag]}"


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


def check_vo(dev, decode_launches: float) -> dict:
    """The main path: vo_init + VO_STEPS vo_step at 1080x1920, defaults.
    Returns what P1 is compared with: the frames, K, counts, every frame's
    keypoint buffer, the outputs, step ms, stage split, device profile and
    `decode_launches` (check_step_launches)."""
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig, vo_step
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts
    from sift_pyocl_tpu_torch.utils import profiling

    cfg, vo = SiftConfig(), VOConfig()
    h, w = SHAPE
    K = torch.tensor([[1000.0, 0, w / 2], [0, 1000.0, h / 2], [0, 0, 1]], device=dev)
    host = profiling.vo_frames(SHAPE, VO_STEPS + 8)
    imgs = [torch.from_numpy(f).to(dev) for f in host]
    run_vo(imgs[:3], K, cfg, vo, plain=False)      # warm-up: allocator, cuDNN
    bufs = []
    state, outs, step_ms, init_counts = run_vo(imgs, K, cfg, vo, plain=False, bufs=bufs)
    counts = launch_counts()
    print("vo_init launch counts:", init_counts, flush=True)
    print(f"launch counts over {VO_STEPS} vo_step:", counts, flush=True)
    check_vo_counts(init_counts, counts)
    check_tracked(outs, vo)
    print("n_kp", [int(o.n_kp) for o in outs], "n_matches", [int(o.n_matches) for o in outs],
          "rms_px", [round(float(o.rms_px), 3) for o in outs], flush=True)
    print(f"vo_step {SHAPE} ms (host clock, synchronised): {[round(m, 3) for m in step_ms]}; "
          f"warm mean (steps 2-{VO_STEPS}) {np.mean(step_ms[1:]):.3f}", flush=True)

    # the kernel path against the plain path on the same card
    pstate, pouts, pms, _ = run_vo(imgs, K, cfg, vo, plain=True)
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

    # stage split, device profile and host synchronisations of warm steps
    rest = iter(imgs[VO_STEPS + 1:])
    state, stages = profiling.vo_stage_ms(state, [next(rest) for _ in range(3)], K, cfg, vo)
    print("vo stage split (device ms, CUDA events):",
          {k: round(v, 3) for k, v in stages.items()}, flush=True)
    box = [state]

    def one():
        box[0], _ = vo_step(box[0], next(rest), K, cfg, vo)

    prof = profiling.device_profile(one, 1, sessions=2)
    check_step_launches("main path", prof, STEP_LAUNCHES, decode_launches)
    print("vo_step device profile:", json.dumps(prof), flush=True)
    syncs = host_syncs(one)
    print(f"host synchronisations in one vo_step: {len(syncs)}", flush=True)
    for line in sorted(set(syncs)):
        print("  sync:", line[:160])
    return {"imgs": imgs, "K": K, "counts": counts, "bufs": bufs, "outs": outs,
            "step_ms": step_ms, "stages": stages, "profile": prof,
            "decode_launches": decode_launches}


def check_vo_k8(base: dict) -> dict:
    """P1: the main path with SiftConfig(mask_backend="pallas"), against the
    default mask's run of check_vo on the same frames."""
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig, vo_step
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts
    from sift_pyocl_tpu_torch.utils import profiling

    cfg, vo = SiftConfig(mask_backend="pallas"), VOConfig()
    imgs, K = base["imgs"], base["K"]
    run_vo(imgs[:3], K, cfg, vo, plain=False)      # warm-up
    bufs = []
    state, outs, step_ms, init_counts = run_vo(imgs, K, cfg, vo, plain=False, bufs=bufs)
    counts = launch_counts()
    print(f"P1 (mask_backend='pallas') launch counts over {VO_STEPS} vo_step:", counts,
          flush=True)
    check_vo_counts(init_counts, counts, extra=("extrema_masks",))
    check_tracked(outs, vo)
    assert len(bufs) == len(base["bufs"]) == VO_STEPS + 1
    for i, (a, b) in enumerate(zip(bufs, base["bufs"])):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f"frame {i}: {f} differs"
    gap = max(float((outs[-1].R - base["outs"][-1].R).abs().max()),
              float((outs[-1].t - base["outs"][-1].t).abs().max()))
    assert gap <= 1e-6, f"final pose {gap} from the default mask's run"
    rest = iter(imgs[VO_STEPS + 1:])
    state, stages = profiling.vo_stage_ms(state, [next(rest) for _ in range(3)], K, cfg, vo)
    box = [state]

    def one():
        box[0], _ = vo_step(box[0], next(rest), K, cfg, vo)

    prof = profiling.device_profile(one, 1, sessions=2)
    check_step_launches("P1", prof, STEP_LAUNCHES_P1, base["decode_launches"])
    print(f"P1: {VO_STEPS} frames tracked, every keypoint buffer equal to the default "
          f"mask's, final pose {gap:.3g} apart", flush=True)
    # the two mask backends in turns (default, K8, K8, default) in this one
    # process: warm steps' wall ms and the host thread's CPU ms
    for tag, turn_cfg in (("default", SiftConfig()), ("K8", cfg), ("K8", cfg),
                          ("default", SiftConfig())):
        gc.collect()
        wall, cpu = timed_vo_steps(imgs, K, turn_cfg, vo)
        print(f"  turn {tag}: warm ms/step {np.mean(wall[1:]):.3f} (range {min(wall[1:]):.3f}-"
              f"{max(wall[1:]):.3f}), host thread CPU ms/step {np.mean(cpu[1:]):.3f}", flush=True)
    for tag, ms, st, dev_prof in (("default mask", base["step_ms"], base["stages"],
                                   base["profile"]), ("K8 mask", step_ms, stages, prof)):
        print(f"  {tag}: ms/step warm mean {np.mean(ms[1:]):.3f} (range {min(ms[1:]):.3f}-"
              f"{max(ms[1:]):.3f}); stage split {({k: round(v, 3) for k, v in st.items()})}; "
              f"device ms/step {dev_prof['kernel_ms_per_frame']:.3f}, launches/step "
              f"{dev_prof['kernel_launches_per_frame']:.0f}, busy share "
              f"{dev_prof['busy_share']:.3f}",
              flush=True)
    return {"counts": counts, "step_ms": step_ms, "stages": stages, "profile": prof}


def check_per_octave(img, dev) -> dict:
    """P2: SiftPlan.keypoints with kp_multi_launch=False."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan

    cfg = SiftConfig(kp_multi_launch=False)
    n_oct = cfg.n_octaves(SHAPE)
    plan = SiftPlan(SHAPE, config=cfg, device=dev)
    multi = SiftPlan(SHAPE, config=SiftConfig(grad_backend="xla"), device=dev)
    kp, frame_ms, counts = plan_frames(plan, img)
    print(f"P2 (kp_multi_launch=False) launch counts over {FRAMES} frames:", counts, flush=True)
    for name, n in counts.items():
        want = {"compact_mask": n_oct, "refine_octave": n_oct, "orient_desc_fused": n_oct,
                "octave0_ladder": 1, "small_octaves_ladder": 1}.get(name, 0) * FRAMES
        assert n == want, f"P2: {name} launched {n} times in {FRAMES} frames (want {want})"
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
    kp, frame_ms, counts = plan_frames(SiftPlan(SHAPE, config=cfg, device=dev), img)
    print(f"P3 (desc_buckets=2) launch counts over {FRAMES} frames:", counts, flush=True)
    for name, n in counts.items():
        want = {"orient_desc_fused": 2}.get(name, 1 if name in VO_KERNELS[:5] else 0) * FRAMES
        assert n == want, f"P3: {name} launched {n} times in {FRAMES} frames (want {want})"
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
    kp, frame_ms, counts = plan_frames(SiftPlan(SHAPE, config=cfg, device=dev), img)
    print(f"P4 (scales=2) launch counts over {FRAMES} frames:", counts, flush=True)
    for name, n in counts.items():
        want = {"separable_blur": 5, "octave0_ladder": 0}.get(
            name, 1 if name in VO_KERNELS[1:6] else 0) * FRAMES
        assert n == want, f"P4: {name} launched {n} times in {FRAMES} frames (want {want})"
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
    (K11b); held against K6 (orient_and_describe_fused) and against the
    plain versions on the same keypoints."""
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

    win_o, win_d = od._ori_window_size(cfg), od._desc_window_size(cfg)
    flips_k6 = flips_plain = 0
    err_h = err_d = 0.0
    n_kv = n_ok = n_slots = n_dslots = 0
    n_circle = n_square = 0
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
        split = _by_keypoint(okps, desc, cap, m, dense=True)
        fused = _by_keypoint(*od.orient_and_describe_fused(mags, oris, kps, cfg, m), cap, m,
                             dense=False)
        plain = _by_keypoint(okps_p, od.quantize_descriptors(raw_p), cap, m, dense=True)
        flips_k6 += _compare_oriented(f"octave {o}, K11a/K11b vs K6", split, fused)
        flips_plain += _compare_oriented(f"octave {o}, K11a/K11b vs plain", split, plain)
        n_kv += int(kps.valid.sum())
        n_ok += int(okps.valid.sum())
        n_slots += cap
        n_dslots += okps.valid.numel()
    print(f"P5: {n_kv} keypoints, {n_ok} oriented slots; ok flags differing from K6 "
          f"{flips_k6}, from the plain versions {flips_plain}; hist err {err_h:.3g}, "
          f"unit descriptor err {err_d:.3g}", flush=True)
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
    # its inputs and its f32 output row
    rec.record("orientation_hist", "sift_pyocl_tpu_torch/csrc/window.cu",
               f"{ROOT}/ops/pallas/window.py:193", err_h,
               each_octave(lambda *p: window.orientation_hist(*ori_args(*p))),
               each_octave(lambda *p: window.orientation_hist_ref(*ori_args(*p))), 20,
               n_bytes=n_slots * (17 + 36 * 4) + n_circle * 8, ops=n_circle * 10,
               wrapper_calls=len(per))
    rec.record("descriptor_hist", "sift_pyocl_tpu_torch/csrc/window.cu",
               f"{ROOT}/ops/pallas/window.py:321", err_d,
               each_octave(lambda *p: window.descriptor_hist(*desc_args(*p))),
               each_octave(lambda *p: window.descriptor_hist_ref(*desc_args(*p))), 20,
               n_bytes=n_dslots * (21 + 128 * 4) + n_square * 8, ops=n_square * 20,
               wrapper_calls=len(per))
    print(f"P5: window samples read: K11a {n_circle} ({n_circle / max(1, n_kv):.0f} a keypoint "
          f"of {win_o}^2), K11b {n_square} ({n_square / max(1, n_ok):.0f} a slot of {win_d}^2)",
          flush=True)
    for name, args in (("orientation_hist", ori_args), ("descriptor_hist", desc_args)):
        fn = getattr(window, name)
        ms = device_ms(each_octave(lambda *p: fn(*args(*p))), f"{name}_kernel")
        print(f"{name}: device time of its {len(per)} kernels {ms:.4f} ms a frame "
              "(torch.profiler)", flush=True)
    return counts


def check_plain_keypoints(img, dev) -> None:
    """P6: SiftPlan.keypoints with kp_backend="xla" (plain PyTorch after the
    K1/K2 pyramid), against the kernel path on the same frame."""
    from sift_pyocl_tpu_torch import SiftConfig, SiftPlan
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets

    kp, frame_ms, counts = plan_frames(SiftPlan(SHAPE, config=SiftConfig(kp_backend="xla"),
                                                device=dev), img, frames=1)
    print("P6 (kp_backend='xla') launch counts over one frame:", counts, flush=True)
    for name, n in counts.items():
        want = 1 if name in ("octave0_ladder", "small_octaves_ladder") else 0
        assert n == want, f"P6: {name} launched {n} times (want {want})"
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
    default mask's run of check_vo on the same frames, beside P1."""
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig, vo_step
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts
    from sift_pyocl_tpu_torch.ops.kernels.maskk import stencil_mask
    from sift_pyocl_tpu_torch.utils import profiling

    cfg, vo = SiftConfig(mask_backend="fused"), VOConfig()
    imgs, K = base["imgs"], base["K"]
    run_vo(imgs[:3], K, cfg, vo, plain=False)      # warm-up
    bufs = []
    stencil_mask.calls = 0
    state, outs, step_ms, init_counts = run_vo(imgs, K, cfg, vo, plain=False, bufs=bufs)
    counts = launch_counts()
    stencil_calls = stencil_mask.calls
    print(f"P7 (mask_backend='fused') launch counts over {VO_STEPS} vo_step:", counts,
          f"plain stencil calls (vo_init and the steps): {stencil_calls}", flush=True)
    check_vo_counts(init_counts, counts, ladders=FUSED_LADDERS)
    assert stencil_calls == 0, f"the plain stencil ran {stencil_calls} times on the fused path"
    check_tracked(outs, vo)
    assert len(bufs) == len(base["bufs"]) == VO_STEPS + 1
    for i, (a, b) in enumerate(zip(bufs, base["bufs"])):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f"P7 frame {i}: {f} differs"
    gap = max(float((outs[-1].R - base["outs"][-1].R).abs().max()),
              float((outs[-1].t - base["outs"][-1].t).abs().max()))
    assert gap <= 1e-6, f"P7: final pose {gap} from the default mask's run"
    rest = iter(imgs[VO_STEPS + 1:])
    state, stages = profiling.vo_stage_ms(state, [next(rest) for _ in range(3)], K, cfg, vo)
    box = [state]

    def one():
        box[0], _ = vo_step(box[0], next(rest), K, cfg, vo)

    prof = profiling.device_profile(one, 1, sessions=2)
    check_step_launches("P7", prof, STEP_LAUNCHES_FUSED, base["decode_launches"])
    print(f"P7: {VO_STEPS} frames tracked, every keypoint buffer equal to the default "
          f"mask's, final pose {gap:.3g} apart", flush=True)
    for tag, turn_cfg in (("default", SiftConfig()), ("fused", cfg), ("fused", cfg),
                          ("default", SiftConfig())):
        gc.collect()
        wall, cpu = timed_vo_steps(imgs, K, turn_cfg, vo)
        print(f"  turn {tag}: warm ms/step {np.mean(wall[1:]):.3f} (range {min(wall[1:]):.3f}-"
              f"{max(wall[1:]):.3f}), host thread CPU ms/step {np.mean(cpu[1:]):.3f}", flush=True)
    for tag, run in (("default mask", base), ("K8 mask (P1)", p1),
                     ("fused mask (P7)", {"step_ms": step_ms, "stages": stages,
                                          "profile": prof})):
        ms, dev_prof = run["step_ms"], run["profile"]
        print(f"  {tag}: ms/step warm mean {np.mean(ms[1:]):.3f} (range {min(ms[1:]):.3f}-"
              f"{max(ms[1:]):.3f}); stage split "
              f"{({k: round(v, 3) for k, v in run['stages'].items()})}; device ms/step "
              f"{dev_prof['kernel_ms_per_frame']:.3f}, launches/step "
              f"{dev_prof['kernel_launches_per_frame']:.0f}, busy share "
              f"{dev_prof['busy_share']:.3f}", flush=True)
    return counts


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
    stencil_mask.calls = 0
    kp, frame_ms, counts = plan_frames(plan, img)
    stencil_calls = stencil_mask.calls
    print(f"fused scales=2 launch counts over {FRAMES} frames:", counts,
          f"plain stencil calls (with the warm-up frame): {stencil_calls}", flush=True)
    for name, n in counts.items():
        want = {"separable_blur": 5, "small_octaves_ladder_mask": 1}.get(
            name, 1 if name in VO_KERNELS[2:6] else 0) * FRAMES
        assert n == want, f"fused scales=2: {name} launched {n} times (want {want})"
    assert stencil_calls == FRAMES + 1, f"the stencil ran {stencil_calls} times for octave 0"
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
    worst = 0.0
    for scale in (512.0, 255.0):
        a, b = f1.desc.float() / scale, f0.desc[map_ids].float() / scale
        got = matchk.best2_l2(a, b, v2, v1)
        want = matchk.best2_l2_ref(a, b, v2)
        torch.cuda.synchronize()
        mag = (a * a).sum(1) + float((b * b).sum(1).max())
        err = max(float(((g - w).abs() / mag)[v1].max()) for g, w in zip(got[:2], want[:2]))
        near = (want[1] - want[0]) <= F32_RTOL * mag
        diff_i = v1 & (got[2] != want[2])
        assert err <= F32_RTOL, f"K7f (1/{scale:g}) d1/d2 differ by {err} of their magnitude"
        assert not bool((diff_i & ~near).any()), f"K7f (1/{scale:g}): i1 differs off a near-tie"
        print(f"best2_l2_f32 (1/{scale:g}, {a.shape[0]} x {b.shape[0]}, {n_valid} valid rows): "
              f"d1/d2 within {err:.3g} of their magnitude (limit {F32_RTOL:g}); i1 differs "
              f"on {int(diff_i.sum())} rows, {int((near & v1).sum())} valid rows are near-ties",
              flush=True)
        worst = max(worst, err)
    a, b = f1.desc.float() / 512.0, f0.desc[map_ids].float() / 512.0

    def library():
        torch.topk(torch.mm(a, b.T), 2, dim=1, largest=False)

    # least work: 2 x 128 f32 operations a (valid row, column) pair at the
    # f32 rate outside the tensor cores; each input read once
    rec.record("best2_l2_f32", "sift_pyocl_tpu_torch/csrc/matchk.cu",
               f"{ROOT}/ops/pallas/matchk.py:113", worst,
               lambda: matchk.best2_l2(a, b, v2, v1), lambda: matchk.best2_l2_ref(a, b, v2), 50,
               n_bytes=4 * (a.numel() + b.numel()) + v1.numel() + v2.numel() + 12 * a.shape[0],
               ops=2 * 128 * n_valid * b.shape[0], library=library)
    return counts


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
    """One align call with every launch counter reset just before it; K1-K6
    once, K7 never (the default metric is L1)."""
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = la.align(img, return_all=True, **kw)
    counts = launch_counts()
    for name in FRONTEND:
        assert counts[name] == 1, f"align({kw}): {name} launched {counts[name]} times"
    assert counts["best2_l2"] == 0, f"align({kw}): K7 launched {counts['best2_l2']} times"
    assert out is not None, f"align({kw}) found too few matches"
    return out


def check_api_align(dev) -> dict:
    """Phase A: LinearAlign and MatchPlan at 1080x1920 on the card, the
    reference library's API (tests/test_align.py's tolerances): translation,
    a 2 deg / 1.02x affine, shift_only with double_check, relative over 4
    frames, orsa, MatchPlan(metric="L2") on K7 against the CPU's indices,
    K1-K6 once per align call; ms per warm align call and its split."""
    from sift_pyocl_tpu_torch import LinearAlign, MatchPlan, affine_warp, fit_affine
    from sift_pyocl_tpu_torch.ops.kernels import matchk, reset_launch_counts
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

    # MatchPlan(metric="L2"): one K7 launch a match_index, the CPU's indices
    l2 = MatchPlan(metric="L2", device=dev)
    idx_l2 = None
    for _ in range(2):
        reset_launch_counts()
        idx_l2 = l2.match_index(la.ref_kp, kp)
        assert matchk.best2_l2.launches == 1, f"K7 launched {matchk.best2_l2.launches} times"
    want_l2 = MatchPlan(metric="L2", device="cpu").match_index(la.ref_kp, kp)
    np.testing.assert_array_equal(idx_l2, want_l2)
    want_l1 = MatchPlan(device="cpu").match_index(la.ref_kp, kp)
    np.testing.assert_array_equal(la.match_plan.match_index(la.ref_kp, kp), want_l1)
    print(f"MatchPlan L2: {len(idx_l2)} matches, one K7 launch a call, equal to the CPU's; "
          f"L1 (default): {len(want_l1)} matches, equal to the CPU's", flush=True)

    # ms per warm align call (host image in, host result out) and its split
    counted_align(la, img)
    torch.cuda.synchronize()
    align_ms = []
    for _ in range(API_CALLS):
        t = time.perf_counter()
        la.align(img, return_all=True)
        torch.cuda.synchronize()
        align_ms.append(1e3 * (time.perf_counter() - t))

    p_r = np.stack([la.ref_kp["y"][out["matches"][:, 0]], la.ref_kp["x"][out["matches"][:, 0]]], 1)
    p_i = np.stack([kp["y"][out["matches"][:, 1]], kp["x"][out["matches"][:, 1]]], 1)
    split = {
        "keypoints": host_ms(lambda: la.sift.keypoints(img)),
        "match": host_ms(lambda: la.match_plan.match_index(la.ref_kp, kp)),
        "fit": host_ms(lambda: fit_affine(p_i, p_r)),
        "warp": host_ms(lambda: affine_warp(img, out["matrix"], out["offset"],
                                            device=dev).cpu().numpy()),
    }
    l2_ms = host_ms(lambda: l2.match_index(la.ref_kp, kp))
    orsa_ms = host_ms(lambda: la.align(img, orsa=True))
    l1_launches, l1_dev = profile_calls(lambda: la.match_plan.match_index(la.ref_kp, kp))
    l2_launches, l2_dev = profile_calls(lambda: l2.match_index(la.ref_kp, kp))
    warp_launches, warp_dev = profile_calls(
        lambda: affine_warp(img, out["matrix"], out["offset"], device=dev))
    syncs = host_syncs(lambda: la.align(img))
    syncs_orsa = host_syncs(lambda: la.align(img, orsa=True))
    n1, n2 = len(la.ref_kp), len(kp)
    report = {"align_ms": align_ms, "align_ms_mean": float(np.mean(align_ms)),
              "split_ms": split, "orsa_align_ms": orsa_ms,
              "keypoints": [n1, n2], "matches": len(out["matches"]),
              "l1_match": {"ms": split["match"], "cuda_launches": l1_launches,
                           "device_ms": l1_dev, "int_ops": 3 * 128 * n1 * n2},
              "l2_match": {"ms": l2_ms, "cuda_launches": l2_launches, "device_ms": l2_dev},
              "warp": {"cuda_launches": warp_launches, "device_ms": warp_dev,
                       "bytes": 3 * 4 * SHAPE[0] * SHAPE[1]},
              "host_syncs": len(syncs), "host_syncs_orsa": len(syncs_orsa)}
    print(f"align {SHAPE} ms (host clock, host image in, host result out, synchronised): "
          f"{[round(v, 3) for v in align_ms]} (mean {report['align_ms_mean']:.3f}); split "
          f"{ {k: round(v, 3) for k, v in split.items()} }; orsa align {orsa_ms:.3f} ms; "
          f"keypoints {n1} / {n2}, matches {len(out['matches'])}", flush=True)
    print(f"L1 matcher (default): {split['match']:.3f} ms a call, {l1_launches:g} CUDA launches "
          f"and {l1_dev:.4f} device ms a call, {3 * 128 * n1 * n2:.4g} int operations; "
          f"L2 (K7): {l2_ms:.3f} ms, {l2_launches:g} launches, {l2_dev:.4f} device ms; warp "
          f"{warp_launches:g} launches, {warp_dev:.4f} device ms", flush=True)
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
    zoom fence and the angle fence."""
    from sift_pyocl_tpu_torch import MatchPlan, SiftConfig, SiftPlan
    from sift_pyocl_tpu_torch.utils import invariance as inv

    plan = SiftPlan(inv.SHAPE, device=dev)
    mp = MatchPlan(device=dev)
    failures, rows = [], {}
    for scene, img in inv.scenes().items():
        kp0 = plan.keypoints(img)
        assert len(kp0) >= 50, f"{scene}: {len(kp0)} keypoints"
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


def captured_registration(sfm, frame: int) -> list:
    """Wrap sfm._register_frame so that the call registering `frame` keeps
    a copy of its arguments (filled in the list returned)."""
    orig, kept = sfm._register_frame, []

    def wrapper(f, *args):
        if f == frame and not kept:
            kept.append((f,) + tuple(np.array(a) if isinstance(a, np.ndarray) else a
                                     for a in args))
        return orig(f, *args)

    sfm._register_frame = wrapper
    return kept


def check_sfm(dev) -> dict:
    """Phase C: IncrementalSfM over the config-4 sequence on the card, twice
    (two objects, one seed).  Gates: 50 of 50 frames registered, ATE <
    0.05, map points within 20 % of 672, a loop edge, the two runs equal in
    every bit of Rs, ts and points, K1-K6 once per frame detected (their
    launch counters) and K7 never (the L1 matcher).  Prints the second
    run's wall time, s/frame and phase_times; for one registered frame
    (detection included) its CUDA launches and device ms (torch.profiler)
    and its host synchronisations (sync debug mode); and the BA's segment
    sum held to a float64 sum and to itself on the final BA's ids."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sift_pyocl_tpu_torch.ops.match import match_descriptors_dense
    from sift_pyocl_tpu_torch.sfm import IncrementalSfM, ate_rmse, camera_centers
    from sift_pyocl_tpu_torch.sfm.pnp import ransac_pnp
    from sift_pyocl_tpu_torch.sfm.segment import segment_sum, segments
    from sift_pyocl_tpu_torch.utils.render3d import render_sequence

    t = time.perf_counter()
    K, frames, gtR, gtT = render_sequence(**CONFIG4_SEQ)
    render_s = time.perf_counter() - t
    print(f"[config4] rendered {len(frames)} frames {frames[0].shape} in {render_s:.1f} s "
          "(NumPy, host)", flush=True)
    kw = dict(cfg=SiftConfig(kp_per_octave_cap=256), ba_every=8, device=dev)
    runs, kept = [], None
    for i in range(2):
        sfm = IncrementalSfM(K, frames[0].shape, **kw)
        if i == 1:
            kept = captured_registration(sfm, CONFIG4_FRAME)
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = sfm.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        assert res is not None, f"config 4 run {i}: bootstrap failed"
        reg = res.frames_registered
        ate = ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg]))
        print(f"[config4] run {i}: {wall:.3f} s ({wall / len(frames):.4f} s/frame), "
              f"{len(reg)} registered, ATE {ate:.5f}, {len(res.points)} points, {res.n_obs} "
              f"observations, {sfm.n_loop_edges} loop edges, bootstrap (0, {reg[1]}), "
              f"{sfm.n_detected} frames detected; phases (s) "
              f"{ {k: round(v, 4) for k, v in sfm.phase_times.items()} }", flush=True)
        assert len(reg) == len(frames), f"run {i}: {len(reg)} of {len(frames)} registered"
        assert ate < 0.05, f"run {i}: ATE {ate}"
        assert abs(len(res.points) - CONFIG4_POINTS) <= 0.2 * CONFIG4_POINTS, len(res.points)
        assert sfm.n_loop_edges >= 1, f"run {i}: no loop edge"
        for name in FRONTEND:
            assert counts[name] == sfm.n_detected, \
                f"run {i}: {name} launched {counts[name]} times for {sfm.n_detected} frames"
        assert counts["best2_l2"] == 0, f"run {i}: K7 launched {counts['best2_l2']} times"
        runs.append(dict(sfm=sfm, res=res, wall=wall, ate=ate, counts=counts,
                         detected=sfm.n_detected, phases=dict(sfm.phase_times)))
    a, b = runs[0]["res"], runs[1]["res"]
    for field in ("Rs", "ts", "points"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.shape == y.shape and np.array_equal(x, y), f"the two runs differ in {field}"
    print("[config4] the two runs are bit-equal in Rs, ts and points", flush=True)

    # one registered frame, detection included: launches, device ms, syncs
    sfm = runs[1]["sfm"]
    assert kept, f"frame {CONFIG4_FRAME} was not registered"
    args = kept[0]

    def one_frame():
        sfm._bufs.pop(CONFIG4_FRAME, None)
        return sfm._register_frame(*args)

    out = one_frame()
    assert int(out.n_inl) >= 10, int(out.n_inl)
    launches, dev_ms = profile_calls(one_frame)
    syncs = host_syncs(one_frame)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        one_frame()
    frame_ms = 1e3 * (time.perf_counter() - t) / 5
    print(f"[config4] one registered frame (frame {CONFIG4_FRAME}, map {len(args[3])} points, "
          f"detection included): {frame_ms:.3f} ms host clock, {launches:g} CUDA launches, "
          f"{dev_ms:.4f} device ms, {len(syncs)} host synchronisations", flush=True)
    for line in sorted(set(syncs)):
        print("  sync:", line[:160])
    # its split: detection, the L1 map match, RANSAC-PnP (the same inputs)
    buf = sfm._buf(CONFIG4_FRAME)
    mdesc, mvalid, mX = (sfm._dev(a) for a in (args[2], args[1], args[3]))
    R0, t0 = sfm._dev(args[7]), sfm._dev(args[8])
    keep = torch.from_numpy(out.keep).to(dev).float()
    uv_m = torch.from_numpy(out.uv).to(dev)
    split = {}
    for name, fn in (
            ("detect", lambda: sfm.sift.keypoints_raw(frames[CONFIG4_FRAME])),
            ("match_l1", lambda: match_descriptors_dense(mdesc, mvalid, buf.desc, buf.valid,
                                                         metric="L1", ratio_sq=0.7)),
            ("ransac_pnp", lambda: ransac_pnp(0, sfm.Kt, R0, t0, mX, uv_m, keep, thresh_px=3.0)),
            ("register_no_detect", lambda: sfm._register_frame(*args))):
        n, d = profile_calls(fn)
        split[name] = {"ms": host_ms(fn), "cuda_launches": n, "device_ms": d}
    print(f"[config4] its split: { {k: {m: round(v, 4) for m, v in r.items()} for k, r in split.items()} }",
          flush=True)

    # the segment sum of the scatter-form BA on the final BA's camera and
    # point ids: the same bits on every call, within 1e-4 of float64
    res = runs[1]["res"]
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
    report = {"frames": len(frames), "render_s": render_s,
              "wall_s": [r["wall"] for r in runs],
              "s_per_frame": runs[1]["wall"] / len(frames),
              "phase_times": runs[1]["phases"],
              "registered": len(res.frames_registered), "ate": runs[1]["ate"],
              "points": int(len(res.points)), "observations": int(res.n_obs),
              "loop_edges": runs[1]["sfm"].n_loop_edges, "bootstrap": res.frames_registered[1],
              "detected": runs[1]["detected"],
              "launch_counts": {k: runs[1]["counts"][k] for k in FRONTEND},
              "frame": {"id": CONFIG4_FRAME, "ms": frame_ms, "cuda_launches": launches,
                        "device_ms": dev_ms, "host_syncs": len(syncs), "split": split},
              "segment_sum": {"max_err_f64": seg_err, "ms": seg_ms}}
    print("config4:", json.dumps(report), flush=True)
    return report


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
    check_api_align(dev)
    check_invariance(dev)
    check_sfm(dev)

    # each kernel's launches on its path: the main path (10 vo_step) for
    # K1-K7, P1 (10 vo_step) for K8, P2 (FRAMES frames) for K10a/K10b, P4
    # (FRAMES frames) for K9, P5 (one frame) for K11a/K11b, P7 (10 vo_step)
    # for K1m/K2m, P8 (two f32 matches) for K7f
    counts = {**base["counts"], "extrema_masks": p1["counts"]["extrema_masks"],
              "compact_mask": p2["compact_mask"], "refine_octave": p2["refine_octave"],
              "separable_blur": p4["separable_blur"],
              "orientation_hist": p5["orientation_hist"],
              "descriptor_hist": p5["descriptor_hist"],
              "octave0_ladder_mask": p7["octave0_ladder_mask"],
              "small_octaves_ladder_mask": p7["small_octaves_ladder_mask"],
              "best2_l2_f32": p8["best2_l2_f32"]}
    kernels = []
    for name, row in rec.rows.items():
        row["launches"] = counts[name]
        assert row["launches"] > 0, f"{name} was not launched on its path"
        kernels.append(row)
    assert len(kernels) == 16, f"{len(kernels)} kernel records"
    print(nvidia_smi_line(), flush=True)        # again, so the output's tail names the card
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

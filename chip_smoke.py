#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA SIFT frontend on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit (nvidia-smi).
2. Builds the kernels of sift_pyocl_tpu_torch/csrc/ with nvcc.
3. Runs each kernel of the slice (K3 compaction, K4 refinement, K5 gradient
   atlas, K6 orientation + descriptor) and its plain PyTorch version on the
   same inputs, taken from a 1080x1920 synthetic scene under SLICE_CONFIG,
   asserts parity, and times both with CUDA events.
4. Runs SiftPlan((1080, 1920), config=SLICE_CONFIG).keypoints for a few
   frames with every launch counter reset just before, asserts that each
   kernel ran once per frame, and holds the keypoints to the plain-version
   path on the same card (match_keypoint_sets).
5. Prints a JSON line of per-kernel results, then, as its last line,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (1080, 1920)
FRAMES = 5
MIN_KEYPOINTS = 200
ROOT = "sift_pyocl_tpu"


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


def check_kernels(x: torch.Tensor, cfg):
    """Each kernel against its plain version at the slice's shapes."""
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    from sift_pyocl_tpu_torch.ops.detect import decode_compacted, extrema_mask
    from sift_pyocl_tpu_torch.ops.kernels import compact, gradpad, refine, window
    from sift_pyocl_tpu_torch.ops.orient_desc import _desc_window_size, quantize_descriptors
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space

    results = []

    def record(name, source, replaces, err, fn, ref, iters):
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(ref, max(2, iters // 4))
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
        print(f"{name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms",
              flush=True)

    octaves = build_scale_space(x, cfg)
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    dogs = [d for _, d in octaves]
    blurs = [b for b, _ in octaves]
    masks = [extrema_mask(d, cfg, o) for o, d in enumerate(dogs)]
    torch.cuda.synchronize()

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
    record("compact_masks_multi", "sift_pyocl_tpu_torch/csrc/compact.cu",
           f"{ROOT}/ops/pallas/compact.py:252", float(err),
           lambda: compact.compact_masks_multi(masks, caps),
           lambda: compact.compact_masks_multi_ref(masks, caps), 50)

    # K4: same accepts, same floats (same operation order, no FMA contraction)
    idx, written, _ = got
    s, r, c, valid = decode_compacted(dogs, masks, caps, idx, written, cfg.border_dist)
    args = (dogs, s, r, c, valid, caps, cfg.border_dist, cfg.peak_thresh, cfg.max_interp_moves)
    got = refine.refine_multi(*args)
    want = refine.refine_multi_ref(*args)
    assert torch.equal(got[4], want[4]), "refine accept flags differ"
    acc = want[4] > 0
    err = max(float((g[acc] - w[acc]).abs().max()) for g, w in zip(got[:4], want[:4]))
    assert err <= 1e-5, f"refine differs by {err}"
    record("refine_multi", "sift_pyocl_tpu_torch/csrc/refine.cu",
           f"{ROOT}/ops/pallas/refine.py:334", err,
           lambda: refine.refine_multi(*args), lambda: refine.refine_multi_ref(*args), 50)
    fs, fr, fc = got[0], got[1], got[2]
    kvalid = (got[4] > 0) & valid

    # K5: mag within 1e-5, ori within 1e-5 modulo 2 pi
    got = gradpad.grad_atlas(blurs, cfg.scales)
    want = gradpad.grad_atlas_ref(blurs, cfg.scales)
    assert got[2] == want[2]
    err_m = float((got[0] - want[0]).abs().max())
    d = (got[1] - want[1]).abs()
    err_o = float(torch.minimum(d, 2 * np.pi - d).max())
    err = max(err_m, err_o)
    assert err <= 1e-5, f"gradient atlas differs: mag {err_m}, ori {err_o}"
    record("grad_atlas", "sift_pyocl_tpu_torch/csrc/gradpad.cu",
           f"{ROOT}/ops/pallas/gradpad.py:168", err,
           lambda: gradpad.grad_atlas(blurs, cfg.scales),
           lambda: gradpad.grad_atlas_ref(blurs, cfg.scales), 50)
    mag, ori, row_starts = got

    # K6: same ok flags (up to near-tie peaks), angles within 1e-4, u8
    # descriptors within 1 count (the kernel and the plain version sum the
    # bins in different orders)
    sigma = cfg.init_sigma * 2.0 ** (fs / cfg.scales)
    wargs = (mag, ori, s, fr, fc, sigma, kvalid, _desc_window_size(cfg), cfg.max_ori,
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
    print(f"orient_desc_fused: {n_ok} ok slots, {mismatch} ok flags differ, "
          f"angle err {err_a:.3g}, u8 desc diff max {int(dq.max())} mean {float(dq.float().mean()):.4g}")
    assert err_a <= 1e-4 and int(dq.max()) <= 1 and float(dq.float().mean()) < 0.01
    record("orient_desc_fused", "sift_pyocl_tpu_torch/csrc/window.cu",
           f"{ROOT}/ops/pallas/window.py:688", err,
           lambda: window.orient_desc_fused(*wargs), lambda: window.orient_desc_fused_ref(*wargs), 20)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from sift_pyocl_tpu_torch import SLICE_CONFIG, SiftPlan, detect_and_describe
    from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets, synthetic_scene

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

    cfg = SLICE_CONFIG
    img = synthetic_scene(SHAPE, seed=0)
    x = torch.from_numpy(img).to(dev)
    kernels = check_kernels(x, cfg)

    plan = SiftPlan(SHAPE, config=cfg, device=dev)
    plan.keypoints(img)  # warm-up: allocator, cuDNN algorithm choice
    torch.cuda.synchronize()
    reset_launch_counts()
    frame_ms = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        kp = plan.keypoints(img)
        frame_ms.append(1e3 * (time.perf_counter() - t))
    counts = launch_counts()
    print("launch counts over", FRAMES, "frames:", counts, flush=True)
    for name, n in counts.items():
        assert n == FRAMES, f"{name} launched {n} times in {FRAMES} frames"
    assert len(kp) >= MIN_KEYPOINTS, f"only {len(kp)} keypoints"
    for f in ("x", "y", "scale", "angle"):
        assert np.isfinite(kp[f]).all(), f
    assert kp["desc"].shape == (len(kp), 128)
    print(f"SiftPlan{SHAPE}.keypoints: {len(kp)} keypoints, ms/frame "
          f"{[round(m, 3) for m in frame_ms]} (mean {np.mean(frame_ms):.3f}) on {smi}", flush=True)

    ref = to_keypoint_records(detect_and_describe(x, cfg, plain=True))
    hits, l1 = match_keypoint_sets(ref, kp)
    print(f"plain path: {len(ref)} keypoints, kernel path {len(kp)}, matched {hits}, "
          f"desc L1 {l1:.4f}", flush=True)
    assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
    assert hits >= 0.98 * len(ref) and l1 < 0.1

    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

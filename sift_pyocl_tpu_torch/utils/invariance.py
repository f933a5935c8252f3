"""The keypoint repeatability / descriptor-matching invariance battery.

A copy of the protocol of the JAX package's ``tests/test_invariance.py``
(which imports jax), run through this package: two scenes on a 256^2 canvas
(the Gaussian-blob scene and the multi-frequency textured scene) warped with
the port's affine warp over the Mikolajczyk axes (rotation, zoom, additive
noise, anisotropic viewpoint tilt, photometric gain/bias), detected with one
``SiftPlan`` and scored by

* repeatability: the fraction of eligible original keypoints (mapped inside
  the frame with a margin) with a detected keypoint within ``TOL_PX`` in the
  transformed image and a scale within a factor ``SCALE_BAND`` of the
  expected one;
* match precision: the fraction of ``MatchPlan`` ratio-test matches whose
  pair agrees with the known transform (< ``MATCH_TOL_PX``).

``FLOORS`` are the reference suite's frozen floors per (scene, case); the
``double_im_size`` zoom fence and the angle-rotation fence come with them.
``tests/test_torch_config.py`` holds the constants, cases, floors and
``_forward_affine`` equal to the originals; ``tests/test_torch_invariance.py``
(``slow``) runs the battery on the CPU and ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .testimage import synthetic_scene, textured_scene

SHAPE = (256, 256)
TOL_PX = 2.0          # repeatability localization tolerance
MATCH_TOL_PX = 3.0    # geometric-consistency tolerance for matches
MARGIN = 12.0         # ignore keypoints mapping near the frame border
SCALE_BAND = 1.7      # detected scale must be within this factor of expected

# (name, angle_deg, zoom, tilt, noise_sigma, gain, bias).  `tilt` is the
# Mikolajczyk viewpoint parameter: the x (column) axis is compressed by
# 1/tilt before rotation/zoom.  gain/bias apply photometrically after the
# warp: I' = clip(gain*I + bias, 0, 255).
CASES = [
    ("rot15",    15.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("rot30",    30.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("rot45",    45.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("rot90",    90.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("zoom_out",  0.0, 0.5, 1.0, 0.0, 1.0, 0.0),
    ("zoom_in",   0.0, 2.0, 1.0, 0.0, 1.0, 0.0),
    ("noise8",    0.0, 1.0, 1.0, 8.0, 1.0, 0.0),
    ("tilt1.4",  20.0, 1.0, 1.4, 0.0, 1.0, 0.0),
    ("gainbias",  0.0, 1.0, 1.0, 0.0, 0.7, 40.0),
]

# Frozen floors per (scene, case): (min_repeatability, min_precision,
# min_eligible, min_matches), the reference suite's (PARITY.md).
FLOORS = {
    ("blobs", "rot15"):    (0.75, 0.90, 25, 40),
    ("blobs", "rot30"):    (0.75, 0.90, 25, 35),
    ("blobs", "rot45"):    (0.75, 0.90, 25, 35),
    ("blobs", "rot90"):    (0.85, 0.90, 25, 50),
    ("blobs", "zoom_out"): (0.55, 0.90, 25, 25),
    ("blobs", "zoom_in"):  (0.55, 0.90, 10, 12),
    ("blobs", "noise8"):   (0.85, 0.90, 25, 50),
    ("blobs", "tilt1.4"):  (0.60, 0.90, 25, 20),
    ("blobs", "gainbias"): (0.85, 0.95, 25, 55),
    ("texture", "rot15"):    (0.70, 0.90, 40, 45),
    ("texture", "rot30"):    (0.70, 0.90, 40, 40),
    ("texture", "rot45"):    (0.70, 0.90, 40, 40),
    ("texture", "rot90"):    (0.80, 0.90, 40, 55),
    ("texture", "zoom_out"): (0.43, 0.85, 40, 20),
    ("texture", "zoom_in"):  (0.45, 0.85, 15, 8),
    ("texture", "noise8"):   (0.75, 0.90, 40, 45),
    ("texture", "tilt1.4"):  (0.55, 0.90, 40, 20),
    ("texture", "gainbias"): (0.80, 0.95, 40, 55),
}

# The fences: the zoom-out case detected with double_im_size=True
# (repeatability, matches), and the share of rot30 matches whose angle
# turns with the image.
ZOOM_FENCE = (0.75, 40)
ANGLE_FENCE = 0.90


def _forward_affine(angle_deg: float, zoom: float, shape, tilt: float = 1.0):
    """Forward map p' = A p + b in (row, col) about the image center.

    A = zoom * R(angle) @ diag(1, 1/tilt): the column axis is foreshortened
    by 1/tilt (viewpoint change about a vertical axis), then rotated/zoomed.
    """
    th = np.deg2rad(angle_deg)
    R = np.array([[np.cos(th), -np.sin(th)],
                  [np.sin(th), np.cos(th)]], np.float64)
    A = zoom * R @ np.diag([1.0, 1.0 / tilt])
    c = np.array([(shape[0] - 1) / 2.0, (shape[1] - 1) / 2.0])
    b = c - A @ c
    return A, b


def _warp(img: np.ndarray, A: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """Apply the FORWARD transform (A, b) with the port's inverse warp."""
    from ..ops.transform import affine_warp

    Ainv = np.linalg.inv(A)
    off = -Ainv @ b
    return affine_warp(img, Ainv.astype(np.float32), off.astype(np.float32),
                       device=device).cpu().numpy()


def _kp_rc(kp):
    """Keypoint positions as (N, 2) (row, col): kp.x is column, kp.y row."""
    return np.stack([np.asarray(kp["y"]), np.asarray(kp["x"])], axis=-1)


def scenes() -> Dict[str, np.ndarray]:
    """The battery's two calibration scenes."""
    return {"blobs": synthetic_scene(SHAPE, n_blobs=90, seed=7),
            "texture": textured_scene(SHAPE, seed=7)}


def transformed(img: np.ndarray, case, device) -> np.ndarray:
    """`img` under `case`: the warp, then the noise and the gain/bias."""
    _, angle, zoom, tilt, noise, gain, bias = case
    A, b = _forward_affine(angle, zoom, SHAPE, tilt)
    warped = _warp(img, A, b, device)
    if noise > 0:
        rng = np.random.default_rng(11)
        warped = warped + rng.normal(0.0, noise, warped.shape)
    if gain != 1.0 or bias != 0.0:
        warped = gain * warped + bias
    return np.clip(warped, 0, 255).astype(np.float32)


def repeatability(kp0, kp1, A, b, s_fac: float) -> Tuple[int, int]:
    """(hits, eligible): eligible keypoints of `kp0` (mapped by (A, b)
    inside the frame with MARGIN) with a keypoint of `kp1` within TOL_PX
    whose scale is within SCALE_BAND of s_fac times theirs."""
    p0 = _kp_rc(kp0)
    mapped = p0 @ A.T + b
    h, w = SHAPE
    inside = ((mapped[:, 0] > MARGIN) & (mapped[:, 0] < h - 1 - MARGIN)
              & (mapped[:, 1] > MARGIN) & (mapped[:, 1] < w - 1 - MARGIN))
    elig = np.where(inside)[0]
    p1 = _kp_rc(kp1)
    s0 = np.asarray(kp0["scale"])
    s1 = np.asarray(kp1["scale"])
    hits = 0
    for i in elig:
        d = np.hypot(p1[:, 0] - mapped[i, 0], p1[:, 1] - mapped[i, 1])
        near = d < TOL_PX
        if not near.any():
            continue
        ratio = s1[near] / max(s0[i] * s_fac, 1e-6)
        if ((ratio < SCALE_BAND) & (ratio > 1.0 / SCALE_BAND)).any():
            hits += 1
    return hits, len(elig)


def match_precision(m, A, b) -> float:
    """Share of matched pairs `m` ((M, 2) records) consistent with (A, b)."""
    if not len(m):
        return 1.0
    pa = np.stack([m[:, 0]["y"], m[:, 0]["x"]], -1)
    pb = np.stack([m[:, 1]["y"], m[:, 1]["x"]], -1)
    good = np.hypot(*(pb - (pa @ A.T + b)).T) < MATCH_TOL_PX
    return float(good.mean())


def run_case(plan, match_plan, img, kp0, case, device) -> dict:
    """One (scene, case): repeatability, precision, eligible and matched
    counts of `case` on `img` (whose keypoints are `kp0`)."""
    _, angle, zoom, tilt = case[:4]
    A, b = _forward_affine(angle, zoom, SHAPE, tilt)
    kp1 = plan.keypoints(transformed(img, case, device))
    hits, n_elig = repeatability(kp0, kp1, A, b, zoom / np.sqrt(tilt))
    m = match_plan.match(kp0, kp1)
    return {"rep": hits / max(n_elig, 1), "hits": hits, "eligible": n_elig,
            "matches": len(m), "prec": match_precision(m, A, b), "kp1": len(kp1)}


def floor_failures(scene: str, name: str, res: dict) -> List[str]:
    """The FLOORS entries of (scene, name) that `res` misses."""
    min_rep, min_prec, min_elig, min_match = FLOORS[(scene, name)]
    out = []
    if res["kp1"] == 0:
        out.append(f"{scene}/{name}: no keypoint in the transformed image")
    if res["eligible"] < min_elig:
        out.append(f"{scene}/{name}: too few eligible kps {res['eligible']}")
    if res["rep"] < min_rep:
        out.append(f"{scene}/{name}: repeatability {res['rep']:.3f} < {min_rep}")
    if res["matches"] < min_match:
        out.append(f"{scene}/{name}: only {res['matches']} ratio-test matches (< {min_match})")
    if res["prec"] < min_prec:
        out.append(f"{scene}/{name}: match precision {res['prec']:.3f} < {min_prec}")
    return out


def zoom_fence(plan, plan_double, match_plan, device) -> Tuple[float, int]:
    """(repeatability, matches) of the 0.5x zoom-out of the blob scene
    detected with a ``double_im_size=True`` plan (`plan_double`): the
    reference's par.DoubleImSize remedy must keep recovering it."""
    img = scenes()["blobs"]
    kp0 = plan.keypoints(img)
    A, b = _forward_affine(0.0, 0.5, SHAPE)
    kp1 = plan_double.keypoints(_warp(img, A, b, device))
    hits, n_elig = repeatability(kp0, kp1, A, b, 0.5)
    return hits / max(n_elig, 1), len(match_plan.match(kp0, kp1))


def angle_fence(plan, match_plan, img, kp0, device) -> Tuple[float, int]:
    """(share, matches): the share of rot30 matches whose orientation
    turns by the image rotation (within 0.30 rad)."""
    th = np.deg2rad(30.0)
    A, b = _forward_affine(30.0, 1.0, SHAPE)
    m = match_plan.match(kp0, plan.keypoints(_warp(img, A, b, device)))
    if not len(m):
        return 0.0, 0
    # image rows grow downward: a +th image rotation shifts gradient
    # orientations by -th in the (x, y)-math convention used for angles
    da = np.asarray(m[:, 1]["angle"]) - np.asarray(m[:, 0]["angle"])
    da = np.mod(da + th + np.pi, 2 * np.pi) - np.pi
    return float((np.abs(da) < 0.30).mean()), len(m)

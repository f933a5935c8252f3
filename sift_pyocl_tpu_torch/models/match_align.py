"""MatchPlan and LinearAlign public APIs, in PyTorch.

Port of ``sift_pyocl_tpu/models/match_align.py`` (reference:
sift-src/match.py::MatchPlan, sift-src/alignment.py::LinearAlign).
``LinearAlign`` is keypoints -> ratio-test matches -> (median shift or
affine least squares, optionally behind RANSAC) -> bilinear warp.  On a CUDA
device its ``SiftPlan`` runs the hand-written kernels K1-K6, and
``MatchPlan(metric="L2")`` runs K7; the default L1 matcher, the warp and
RANSAC are plain PyTorch, as they are plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config import SiftConfig
from ..oracle import KP_DTYPE
from ..ops import resolve_device
from ..ops.match import match_descriptors_jax
from ..ops.transform import affine_warp
from ..sfm.ransac import ransac_affine
from .sift import SiftPlan

Device = Optional[Union[str, torch.device]]


class MatchPlan:
    """Brute-force descriptor matcher (reference: match.py::MatchPlan).

    ``match`` returns an (M, 2) structured array of matched keypoint record
    pairs, like the reference; ``match_index`` their (M, 2) int32 indices.
    ``device`` (default: the current CUDA card; raises without one, so pass
    ``device="cpu"`` for the CPU) is where the distances are computed.

    The JAX package pads each call to a power-of-two bucket to bound its XLA
    compiles; PyTorch compiles nothing and K7 takes any row and column
    count, so the records go in as they are.  Padding rows and columns are
    invalid, so the indices are the same either way.  ``size`` is kept for
    signature parity.
    """

    def __init__(self, size: int = 16384, devicetype: str = "GPU",
                 ratio_th: float = 0.5329, metric: str = "L1",
                 match_xradius: Optional[float] = None,
                 match_yradius: Optional[float] = None, device: Device = None, **_ignored):
        self.size = size
        self.ratio_th = float(ratio_th)
        self.metric = metric
        # reference: par.MatchXradius / par.MatchYradius spatial gating
        self.match_xradius = match_xradius
        self.match_yradius = match_yradius
        self.roi = None
        self.device = resolve_device(device)

    def set_roi(self, roi: np.ndarray):
        """Restrict set-1 keypoints to a region of interest
        (reference: match.py::MatchPlan.set_roi — nonzero mask image)."""
        self.roi = None if roi is None else np.asarray(roi) != 0

    def unset_roi(self):
        self.roi = None

    def _roi_mask(self, kp: np.ndarray) -> np.ndarray:
        if self.roi is None:
            return np.ones(len(kp), dtype=bool)
        r = np.clip(kp["y"].astype(int), 0, self.roi.shape[0] - 1)
        c = np.clip(kp["x"].astype(int), 0, self.roi.shape[1] - 1)
        return self.roi[r, c]

    def _xy(self, kp: np.ndarray) -> torch.Tensor:
        xy = np.stack([kp["x"], kp["y"]], axis=1).astype(np.float32)
        return torch.from_numpy(xy).to(self.device)

    def match_index(self, kp1: np.ndarray, kp2: np.ndarray) -> np.ndarray:
        """(M, 2) int32 indices of matches between two KP_DTYPE arrays."""
        if len(kp1) == 0 or len(kp2) == 0:
            return np.zeros((0, 2), dtype=np.int32)
        dev = self.device
        kwargs = {}
        if self.match_xradius is not None or self.match_yradius is not None:
            kwargs = dict(xy1=self._xy(kp1), xy2=self._xy(kp2),
                          xy_radius=(float(self.match_xradius or np.inf),
                                     float(self.match_yradius or np.inf)))
        res = match_descriptors_jax(
            torch.from_numpy(np.ascontiguousarray(kp1["desc"])).to(dev),
            torch.from_numpy(self._roi_mask(kp1)).to(dev),
            torch.from_numpy(np.ascontiguousarray(kp2["desc"])).to(dev),
            torch.ones(len(kp2), dtype=torch.bool, device=dev),
            metric=self.metric, ratio_sq=self.ratio_th, **kwargs)
        # one copy to the host: idx1, idx2 and valid side by side
        both = torch.stack([res.idx1, res.idx2, res.valid.to(torch.int32)], 1).cpu().numpy()
        return both[both[:, 2] != 0, :2].astype(np.int32)

    def match(self, kp1: np.ndarray, kp2: np.ndarray) -> np.ndarray:
        idx = self.match_index(kp1, kp2)
        out = np.zeros((len(idx), 2), dtype=KP_DTYPE)
        if len(idx):
            out[:, 0] = kp1[idx[:, 0]]
            out[:, 1] = kp2[idx[:, 1]]
        return out

    __call__ = match


def fit_affine(dst: np.ndarray, src: np.ndarray):
    """Least-squares affine fit: dst ≈ matrix @ src + offset, in NumPy f64
    (host work in the reference too).

    (reference: alignment.py CPU lstsq step.)  dst/src are (N, 2) arrays of
    (row, col).
    """
    n = len(dst)
    A = np.zeros((2 * n, 6), dtype=np.float64)
    b = np.zeros(2 * n, dtype=np.float64)
    A[0::2, 0] = src[:, 0]
    A[0::2, 1] = src[:, 1]
    A[0::2, 4] = 1.0
    A[1::2, 2] = src[:, 0]
    A[1::2, 3] = src[:, 1]
    A[1::2, 5] = 1.0
    b[0::2] = dst[:, 0]
    b[1::2] = dst[:, 1]
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    matrix = np.array([[sol[0], sol[1]], [sol[2], sol[3]]])
    offset = np.array([sol[4], sol[5]])
    return matrix, offset


class LinearAlign:
    """Align images to a reference image (reference: alignment.py::LinearAlign).

    SIFT keypoints on the reference at init; per ``align(img)`` call:
    keypoints -> ratio-test matches -> (median shift or affine lstsq) ->
    bilinear warp.  ``device`` (default: the current CUDA card; raises
    without one, so pass ``device="cpu"`` for the CPU) is where its
    ``SiftPlan``, ``MatchPlan``, RANSAC and warp run; the fit is host f64.
    """

    def __init__(self, image: np.ndarray, config: Optional[SiftConfig] = None,
                 devicetype: str = "GPU", device: Device = None, **_ignored):
        self.ref_image = np.asarray(image)
        self.shape = self.ref_image.shape[:2]
        self.cfg = config or SiftConfig()
        self.device = resolve_device(device)
        self.sift = SiftPlan(shape=self.shape, config=self.cfg, device=self.device)
        self.match_plan = MatchPlan(device=self.device)
        self.ref_kp = self.sift.keypoints(self.ref_image)
        # accumulated transform for relative mode (reference: alignment.py
        # `relative` kwarg — align each frame against the PREVIOUS one and
        # compose, for drifting video)
        self._rel_matrix = np.eye(2)
        self._rel_offset = np.zeros(2)

    def align(
        self,
        img: np.ndarray,
        shift_only: bool = False,
        return_all: bool = False,
        relative: bool = False,
        double_check: bool = False,
        orsa: bool = False,
        seed: int = 0,
    ):
        """Warp `img` onto the reference frame.  Returns the warped image (a
        NumPy array), or a dict with (result, matrix, offset, matches) when
        return_all; None with too few matches.

        double_check: symmetric matching — keep only pairs that also win the
        reverse-direction ratio test (reference kwarg).
        relative: fit against the previous frame's keypoints and compose the
        transform (video stabilization mode; reference kwarg).
        orsa: RANSAC affine inlier filtering (``sfm.ransac.ransac_affine``)
        before the final fit, kept only with at least 3 inliers.
        seed: RANSAC sampling seed for orsa (its draws are the port's
        ``torch.Generator``'s, not the JAX package's).
        """
        base_kp = self.ref_kp
        kp = self.sift.keypoints(np.asarray(img))
        idx = self.match_plan.match_index(base_kp, kp)
        if double_check and len(idx):
            rev = self.match_plan.match_index(kp, base_kp)
            fwd = {(int(a), int(b)) for a, b in idx}
            idx = np.array(
                [[b, a] for a, b in rev if (int(b), int(a)) in fwd],
                dtype=np.int32,
            ).reshape(-1, 2)
        if len(idx) < (1 if shift_only else 3):
            return None
        p_ref = np.stack(
            [base_kp["y"][idx[:, 0]], base_kp["x"][idx[:, 0]]], axis=1
        )
        p_img = np.stack([kp["y"][idx[:, 1]], kp["x"][idx[:, 1]]], axis=1)
        if orsa and len(idx) >= 4:
            res = ransac_affine(seed, p_ref.astype(np.float32), p_img.astype(np.float32),
                                np.ones(len(idx), bool), device=self.device)
            inl = res.inliers.cpu().numpy()
            # require a real consensus set even in shift_only mode: a median
            # over all matches beats a "median" of 1-2 RANSAC stragglers
            if inl.sum() >= 3:
                idx, p_ref, p_img = idx[inl], p_ref[inl], p_img[inl]
        # the warp samples img at M @ (ref coords) + offset, so fit the
        # ref -> img mapping: p_img ≈ M @ p_ref + offset
        if shift_only:
            matrix = np.eye(2)
            # median, not mean: a single bad ratio-test match otherwise drags
            # the shift
            offset = np.median(p_img - p_ref, axis=0)
        else:
            matrix, offset = fit_affine(p_img, p_ref)
        if relative:
            # the fit maps previous-frame coords -> img; compose with the
            # accumulated ref -> previous transform, and make this frame the
            # next anchor:  p_img = A (A_acc p_ref + b_acc) + b
            matrix, offset = (
                np.asarray(matrix) @ self._rel_matrix,
                np.asarray(matrix) @ self._rel_offset + np.asarray(offset),
            )
            self._rel_matrix = np.asarray(matrix)
            self._rel_offset = np.asarray(offset)
            self.ref_kp = kp
        warped = affine_warp(np.asarray(img, dtype=np.float32), matrix, offset,
                             device=self.device).cpu().numpy()
        if return_all:
            return {
                "result": warped,
                "matrix": matrix,
                "offset": offset,
                "matches": idx,
            }
        return warped

"""Incremental SfM over an image sequence (BASELINE.json config 4): two-view
init, sequential registration by RANSAC-PnP, new-point triangulation, a pose
graph over loop-closure edges, and bundle adjustment.

Port of ``sift_pyocl_tpu/sfm/pipeline.py``, both of its registration
architectures, which share the bootstrap's gates, the host's map
bookkeeping, the loop closure and the BA:

* FUSED (``fused=True``, the default; ``_register_fused``).  The JAX
  package's per-frame program, ``register_frame_fused``, is split in two:
  each frame is detected once (``SiftPlan.keypoints_raw``: the kernels
  K1-K6) and its keypoint buffer stays on the card;
  ``register_from_buffers`` then matches the map, runs RANSAC-PnP and
  triangulates and gates new points, all on the card.
* HOST (``fused=False``; ``_bootstrap``, ``_register_host`` and
  ``_triangulate_new``, the JAX package's ``_run_host``).  Every frame is
  detected first and its keypoints compacted to the host, as
  ``SiftPlan.keypoints`` gives them; each step (map match on the compacted
  keypoints, RANSAC-PnP on the matched rows, two-view triangulation of the
  fresh matches to the previous registered frame) is its own call, with
  the host choosing what goes in.  Its loop closure probes the candidate
  frames one at a time (``_loop_edges_host``: a host match against the old
  map points, then RANSAC-PnP on the matched rows), as the JAX package's
  host loop does, where the fused path probes them all in one batch
  (``_loop_probe``).

The host keeps the growing map (points, descriptors, observation table) in
NumPy.  On a CUDA device the per-frame programs are CUDA graphs, one per
static signature, as the JAX package jits them: ``SiftPlan``'s detector
(``models.sift.DETECT_GRAPHS``), ``register_from_buffers``
(``REGISTER_GRAPHS``), the host loop's ``ransac_pnp``
(``sfm.pnp.PNP_GRAPHS``) and pair matcher (``PAIR_GRAPHS``), the
bundle adjustment's LM iteration (``sfm.ba.LM_GRAPHS``, replayed once an
iteration), the pose graph's Gauss-Newton step
(``sfm.posegraph.POSEGRAPH_GRAPHS``, likewise), and the fused path's
probes: the bootstrap's (``boot_probe``, ``BOOT_PROBE_GRAPHS``, one graph
a chunk size) and the loop closure's (``loop_probe``,
``LOOP_PROBE_GRAPHS``).  So the map goes in padded to the JAX package's
power-of-two buckets (``_pow2_pad``: 256, 512, ... rows; zero descriptors
and points, rows not valid), as do the host loop's matched rows (weight
0), both descriptor sets of a host-loop match (rows not valid), the BA's
observations (weight 0) and points and the loop probe's old map points
(64, 128, ... rows) and the bootstrap's two-view inits
(``initialize_two_view``, ``sfm.twoview.TWOVIEW_GRAPHS``: the matched
pairs padded to ``_pow2_pad(len(m))`` rows with a valid mask, its
decompositions the kernels K12 and K13), and a call's results come home
in one copy (``graphs.to_host``).  The odometry edges (``relative_pose``,
one batched call) run eagerly.

Random draws: the JAX package splits one key a call; here one CPU
``torch.Generator`` seeded with `seed` gives each call its seed.  So runs
of the two packages agree in outcome, not in bits (the parity tests feed
JAX's RANSAC rows where they hold a choice), and two runs of the port on
one device give the same bits.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import SiftConfig
from ..models.sift import KeypointBuffer, SiftPlan
from ..ops import resolve_device
from ..ops.match import _match_packed, match_descriptors_dense, match_packed
from ..utils import graphs
from .ba import BAObs, BAParams, run_ba
from .geometry import project, triangulate_two_view
from .pnp import pnp_host_draws, pnp_subsets, ransac_pnp, ransac_pnp_given_draws
from .posegraph import PoseGraph, optimize_pose_graph, relative_pose
from .twoview import TwoViewInit, initialize_two_view

logger = logging.getLogger(__name__)


def _say(verbose: bool, msg: str, *args):
    logger.info(msg, *args)
    if verbose:
        print(msg % args if args else msg)


PNP_HYPOTHESES = 16        # ransac_pnp's default, as the registration calls it


def _pow2_pad(n: int, floor: int = 256) -> int:
    """The JAX package's map bucket: the least `floor` * 2^k >= n."""
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_rows(a, P: int, dtype) -> np.ndarray:
    """`a` (n, ...) as `dtype` followed by zero rows (False in a mask) up to
    P rows, as the JAX package pads its map and its matched rows."""
    a = np.asarray(a, dtype)
    return np.concatenate([a, np.zeros((P - len(a),) + a.shape[1:], dtype)])


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of 1-D `x` as ``jnp.nanmedian`` takes
    it: the mean of the two middle values for an even count (torch's
    ``nanmedian`` returns the lower one), NaN when none is finite."""
    n = (~torch.isnan(x)).sum()
    s = torch.sort(x).values                      # NaNs sort last
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.div(n, 2, rounding_mode="floor")
    return (s[lo.view(1)] + s[hi.view(1)])[0] * 0.5


class RegisterOut(NamedTuple):
    """One frame's registration, on the card: P map rows, S new-point rows."""

    R: torch.Tensor            # (3, 3) the frame's pose (world -> camera)
    t: torch.Tensor            # (3,)
    n_inl: torch.Tensor        # () int32 PnP inliers
    n_match: torch.Tensor      # () int32 map rows matched
    keep: torch.Tensor         # (P,) bool map row matched
    inl: torch.Tensor          # (P,) bool map row a PnP inlier
    uv: torch.Tensor           # (P, 2) its matched keypoint
    desc: torch.Tensor         # (P, 128) u8 that keypoint's descriptor
    new_ok: torch.Tensor       # (S,) bool new point passed the gates
    new_X: torch.Tensor        # (S, 3) triangulated point
    new_uv_prev: torch.Tensor  # (S, 2) in the previous registered frame
    new_uv_cur: torch.Tensor   # (S, 2) in this frame
    new_desc: torch.Tensor     # (S, 128) u8


def register_from_buffers(buf: KeypointBuffer, seed: int, map_desc, map_valid, map_X,
                          prev_desc, prev_uv, prev_valid, R_prev_cam, t_prev_cam, R0, t0, K,
                          new_cap: int = 256, ratio_sq: float = 0.7, reproj_px: float = 3.0,
                          metric: str = "L2", draws=None) -> RegisterOut:
    """Register one frame from its keypoint buffer: map -> keypoint ratio
    matching, RANSAC-PnP from (R0, t0), then new landmarks from the previous
    registered frame's keypoints (prev_*, at pose R_prev_cam, t_prev_cam)
    matched to keypoints no map match claimed, triangulated, gated on depth
    and reprojection, and the best `new_cap` by keypoint scale kept.
    ``draws``: ``ransac_pnp``'s draws in place of those from `seed`.

    Runs on the buffer's device; the map, the poses and K may lie on the
    host.  On a CUDA device one CUDA graph per (device, every input's
    shape and dtype: the map's P rows, this frame's and the previous
    frame's buffer capacities; new_cap, ratio_sq, reproj_px, metric, draws
    given) (``REGISTER_GRAPHS``); elsewhere the eager call,
    ``_register_from_buffers_eager``.  The results are views of one buffer
    (``graphs.to_host`` fetches them in one copy)."""
    args = (buf, seed, map_desc, map_valid, map_X, prev_desc, prev_uv, prev_valid, R_prev_cam,
            t_prev_cam, R0, t0, K, new_cap, ratio_sq, reproj_px, metric, draws)
    if buf.desc.device.type != "cuda":
        return _register_from_buffers_eager(*args)
    static, inputs = _register_inputs(*args)
    return RegisterOut(*REGISTER_GRAPHS(buf.desc.device, static, inputs))


def _register_from_buffers_eager(buf: KeypointBuffer, seed: int, map_desc, map_valid, map_X,
                                 prev_desc, prev_uv, prev_valid, R_prev_cam, t_prev_cam, R0, t0,
                                 K, new_cap: int = 256, ratio_sq: float = 0.7,
                                 reproj_px: float = 3.0, metric: str = "L2",
                                 draws=None) -> RegisterOut:
    """``register_from_buffers`` op by op (what its graph captures)."""
    static, inputs = _register_inputs(buf, seed, map_desc, map_valid, map_X, prev_desc, prev_uv,
                                      prev_valid, R_prev_cam, t_prev_cam, R0, t0, K, new_cap,
                                      ratio_sq, reproj_px, metric, draws)
    return RegisterOut(*_register_flat(static, *inputs))


def _register_inputs(buf, seed, map_desc, map_valid, map_X, prev_desc, prev_uv, prev_valid,
                     R_prev_cam, t_prev_cam, R0, t0, K, new_cap, ratio_sq, reproj_px, metric,
                     draws):
    """(static, inputs) of ``_register_flat``: the buffers (on the device)
    first, then the map, the poses, K and the draws where they lie (host
    arrays as CPU tensors).  The draws' numbers are those of
    ``ransac_pnp(seed, ...)`` (16 hypotheses) on the map's rows."""
    def f32(a):
        return torch.as_tensor(a).to(torch.float32)

    map_desc = torch.as_tensor(map_desc)
    xi, g = pnp_host_draws(seed, PNP_HYPOTHESES, map_desc.shape[0]) if draws is None else \
        (f32(d) for d in draws)
    static = (int(new_cap), float(ratio_sq), float(reproj_px), metric, draws is not None)
    return static, (buf.x, buf.y, buf.scale, buf.desc, buf.valid, prev_desc, prev_uv, prev_valid,
                    map_desc, torch.as_tensor(map_valid).bool(),
                    *(f32(a) for a in (map_X, R_prev_cam, t_prev_cam, R0, t0, K)), xi, g)


def _register_flat(static, x, y, scale, desc, valid, prev_desc, prev_uv, prev_valid, map_desc,
                   map_valid, map_X, R_prev_cam, t_prev_cam, R0, t0, K, xi, g):
    """The eager registration on the buffer's device from flat inputs (a
    graph body); `g` the Gumbel noise of the PnP draws (or, given, their
    subsets)."""
    new_cap, ratio_sq, reproj_px, metric, given = static
    dev = desc.device
    map_desc, map_valid, map_X, R_prev_cam, t_prev_cam, R0, t0, K, xi, g = (
        a.to(dev) for a in (map_desc, map_valid, map_X, R_prev_cam, t_prev_cam, R0, t0, K, xi,
                             g))
    kp_uv = torch.stack([x, y], -1)
    N = desc.shape[0]
    # 1. map -> keypoint matching (map points are the queries)
    keep, mid, _, _ = match_descriptors_dense(map_desc, map_valid, desc, valid,
                                              metric=metric, ratio_sq=ratio_sq)
    mid = mid.long()
    uv_m = kp_uv[mid]
    # 2. robust pose from the 2D-3D matches
    w = keep.to(torch.float32)
    sub = g if given else pnp_subsets(g, w)
    R, t, inl, n_inl = ransac_pnp_given_draws(K, R0, t0, map_X, uv_m, w, xi, sub,
                                              thresh_px=reproj_px)
    # 3. new-landmark candidates: the previous registered frame's keypoints
    # matched to current keypoints that no map match claimed
    pk, pidx, _, _ = match_descriptors_dense(prev_desc, prev_valid, desc, valid,
                                             metric=metric, ratio_sq=ratio_sq)
    pidx = pidx.long()
    used_kp = torch.zeros(N, dtype=torch.int32, device=dev).scatter_reduce_(
        0, mid, keep.to(torch.int32), "amax") > 0
    cur_uv = kp_uv[pidx]
    Xn, z1, z2 = triangulate_two_view(K, R_prev_cam, t_prev_cam, K, R, t, prev_uv, cur_uv)
    pa, _ = project(K, R_prev_cam, t_prev_cam, Xn)
    pb, _ = project(K, R, t, Xn)
    ea2 = ((pa - prev_uv) ** 2).sum(-1)
    eb2 = ((pb - cur_uv) ** 2).sum(-1)
    thr2 = float(np.float32(reproj_px) ** 2)
    tri_ok = (pk & ~used_kp[pidx] & (z1 > 1e-3) & (z2 > 1e-3) & (ea2 < thr2) & (eb2 < thr2))
    score = torch.where(tri_ok, scale[pidx], -torch.inf)
    # lax.top_k: the largest scores, ties to the lowest index
    nsel = torch.sort(score, descending=True, stable=True).indices[:min(new_cap, score.shape[0])]
    return RegisterOut(R, t, n_inl, keep.sum(dtype=torch.int32), keep, inl, uv_m, desc[mid],
                       tri_ok[nsel], Xn[nsel], prev_uv[nsel], cur_uv[nsel], desc[pidx[nsel]])


# register_from_buffers's graphs on the card (config 4's fused registration)
REGISTER_GRAPHS = graphs.GraphCache(_register_flat)

# the host loop's pair matcher on the card, one graph per bucket pair (the
# JAX package's ``_match_pairs_packed``)
PAIR_GRAPHS = graphs.GraphCache(_match_packed)


def boot_probe(desc0, valid0, uv0, descs, valids, uvs, ratio_sq: float = 0.7) -> torch.Tensor:
    """The bootstrap's probe of a chunk of candidate frames (the JAX
    package's ``_boot_probe_batched``): frame 0's slots (desc0 (N, 128),
    valid0 (N,), uv0 (N, 2)) L1 ratio-matched to each candidate's (descs
    (n, cap, 128), valids (n, cap), uvs (n, cap, 2)); (n, 2) rows [match
    count, median matched displacement (NaN where none)].  On a CUDA device
    one CUDA graph per (device, shapes: a short last chunk is a key of its
    own, ratio_sq) (``BOOT_PROBE_GRAPHS``); elsewhere the eager call,
    ``_boot_probe_eager``."""
    static, inputs = (float(ratio_sq),), (desc0, valid0, uv0, descs, valids, uvs)
    if descs.device.type != "cuda":
        return _boot_probe_flat(static, *inputs)[0]
    return BOOT_PROBE_GRAPHS(descs.device, static, inputs)[0]


def _boot_probe_eager(desc0, valid0, uv0, descs, valids, uvs, ratio_sq: float = 0.7
                      ) -> torch.Tensor:
    """``boot_probe`` op by op (what its graph captures)."""
    return _boot_probe_flat((float(ratio_sq),), desc0, valid0, uv0, descs, valids, uvs)[0]


def _boot_probe_flat(static, desc0, valid0, uv0, descs, valids, uvs):
    """The bootstrap probe from flat inputs on the candidates' device (a
    graph body)."""
    (ratio_sq,) = static
    rows = []
    for k in range(descs.shape[0]):
        keep, mid, _, _ = match_descriptors_dense(desc0, valid0, descs[k], valids[k],
                                                  metric="L1", ratio_sq=ratio_sq)
        disp = torch.sqrt(((uvs[k][mid.long()] - uv0) ** 2).sum(-1))
        flow = _nanmedian(torch.where(keep, disp, torch.nan))
        rows.append(torch.stack([keep.sum().to(torch.float32), flow]))
    return (torch.stack(rows),)


def loop_probe(descs, valids, uvs, R0s, t0s, old_desc, old_valid, old_X, K, seeds=None,
               ratio_sq: float = 0.7, metric: str = "L1", thresh_px: float = 3.0,
               draws=None) -> torch.Tensor:
    """The loop-closure probe of n candidate frames in one call (the JAX
    package's ``_loop_probe_batched``): the old map points (old_desc (Q,
    128), old_valid (Q,), old_X (Q, 3)) ratio-matched to each candidate's
    slots (descs (n, cap, 128), valids (n, cap), uvs (n, cap, 2)), then
    RANSAC-PnP from its pose (R0s (n, 3, 3), t0s (n, 3)) on the matched
    rows, the candidates under one ``vmap``; (n, 14) rows [match count,
    inlier count, R (9), t (3)].  Each candidate's PnP draws are those of
    ``ransac_pnp(seeds[k], ...)`` over the Q rows, or ``draws`` = (xi (n,
    16, 6), subsets (n, 16, Q)) where given.  The slots and K lie on the
    device; the rest may lie on the host.  On a CUDA device one CUDA graph
    per (device, shapes, ratio_sq, metric, thresh_px, draws given)
    (``LOOP_PROBE_GRAPHS``); elsewhere the eager call, ``_loop_probe_eager``."""
    static, inputs = _loop_probe_inputs(descs, valids, uvs, R0s, t0s, old_desc, old_valid,
                                        old_X, K, seeds, ratio_sq, metric, thresh_px, draws)
    if descs.device.type != "cuda":
        return _loop_probe_flat(static, *inputs)[0]
    return LOOP_PROBE_GRAPHS(descs.device, static, inputs)[0]


def _loop_probe_eager(descs, valids, uvs, R0s, t0s, old_desc, old_valid, old_X, K, seeds=None,
                      ratio_sq: float = 0.7, metric: str = "L1", thresh_px: float = 3.0,
                      draws=None) -> torch.Tensor:
    """``loop_probe`` op by op (what its graph captures)."""
    static, inputs = _loop_probe_inputs(descs, valids, uvs, R0s, t0s, old_desc, old_valid,
                                        old_X, K, seeds, ratio_sq, metric, thresh_px, draws)
    return _loop_probe_flat(static, *inputs)[0]


def _loop_probe_inputs(descs, valids, uvs, R0s, t0s, old_desc, old_valid, old_X, K, seeds,
                       ratio_sq, metric, thresh_px, draws):
    """(static, inputs) of ``_loop_probe_flat``: the slots and K (on the
    device) first, then the old map, the poses and the draws where they lie
    (host arrays as CPU tensors): each candidate's host numbers
    (``pnp_host_draws``: jitter, Gumbel noise) from its seed, or the
    caller's (xi, subsets)."""
    def f32(a):
        return torch.as_tensor(a).to(torch.float32)

    old_desc = torch.as_tensor(old_desc)
    if draws is None:
        xi, g = (torch.stack(d) for d in zip(*(
            pnp_host_draws(s, PNP_HYPOTHESES, old_desc.shape[0]) for s in seeds)))
    else:
        xi, g = (f32(d) for d in draws)
    static = (float(ratio_sq), metric, float(thresh_px), draws is not None)
    return static, (descs, valids, uvs, K, old_desc, torch.as_tensor(old_valid).bool(),
                    *(f32(a) for a in (old_X, R0s, t0s)), xi, g)


def _loop_probe_flat(static, descs, valids, uvs, K, old_desc, old_valid, old_X, R0s, t0s, xi, g):
    """The loop-closure probe from flat inputs on the slots' device (a graph
    body); `g` the Gumbel noise of the PnP draws (or, given, their
    subsets)."""
    ratio_sq, metric, thresh_px, given = static
    dev = descs.device
    old_desc, old_valid, old_X, R0s, t0s, xi, g = (
        a.to(dev) for a in (old_desc, old_valid, old_X, R0s, t0s, xi, g))
    keeps, uv_m = [], []
    for k in range(descs.shape[0]):
        keep, mid, _, _ = match_descriptors_dense(old_desc, old_valid, descs[k], valids[k],
                                                  metric=metric, ratio_sq=ratio_sq)
        keeps.append(keep)
        uv_m.append(uvs[k][mid.long()])
    W = torch.stack(keeps).to(torch.float32)
    sub = g if given else pnp_subsets(g, W)
    probe = torch.func.vmap(lambda R0, t0, uv, w, xi_, sub_: ransac_pnp_given_draws(
        K, R0, t0, old_X, uv, w, xi_, sub_, thresh_px=thresh_px))
    R, t, _, n_inl = probe(R0s, t0s, torch.stack(uv_m), W, xi, sub)
    return (torch.cat([W.sum(1, keepdim=True), n_inl[:, None].to(torch.float32),
                       R.reshape(-1, 9), t], 1),)


# the fused path's probes on the card, one graph per (shapes, static
# arguments), as the JAX package jits ``_boot_probe_batched`` and
# ``_loop_probe_batched``
BOOT_PROBE_GRAPHS = graphs.GraphCache(_boot_probe_flat)
LOOP_PROBE_GRAPHS = graphs.GraphCache(_loop_probe_flat)


class Registration(NamedTuple):
    """One frame's registration on the host, from either architecture: the
    match and inlier counts, and past the gates the pose, the map rows that
    are PnP inliers with their keypoints and descriptors, and the new
    points with their keypoints in the previous registered frame and in
    this one."""

    n_match: int
    n_inl: int
    R: Optional[np.ndarray] = None          # (3, 3) f32
    t: Optional[np.ndarray] = None          # (3,)
    rows: Optional[np.ndarray] = None       # (I,) map rows
    uv: Optional[np.ndarray] = None         # (I, 2)
    desc: Optional[np.ndarray] = None       # (I, 128) u8
    new_X: Optional[np.ndarray] = None      # (S, 3) f32
    new_uv_prev: Optional[np.ndarray] = None
    new_uv_cur: Optional[np.ndarray] = None
    new_desc: Optional[np.ndarray] = None


@dataclass
class SfMResult:
    Rs: np.ndarray                 # (F, 3, 3) world-to-camera
    ts: np.ndarray                 # (F, 3)
    points: np.ndarray             # (P, 3)
    n_obs: int
    frames_registered: List[int] = field(default_factory=list)


class IncrementalSfM:
    """Sequential SfM: bootstrap pair -> PnP registration -> triangulate new
    points -> periodic BA -> loop closure -> final BA, fused (``fused=True``)
    or host-orchestrated (``fused=False``).  Runs on `device` (None: the
    CUDA card; raises without one).  ``run`` fills
    ``phase_times`` (wall s of bootstrap, register, periodic_ba,
    loop_closure and final_ba), ``n_loop_edges`` and ``n_detected`` (the
    frames the frontend ran on, once each)."""

    def __init__(self, K: np.ndarray, frame_shape, cfg: Optional[SiftConfig] = None,
                 min_boot_flow_px: float = 8.0, min_matches: int = 30, reproj_px: float = 3.0,
                 ba_every: int = 8, ratio_sq: float = 0.7, seed: int = 0,
                 loop_closure: bool = True, loop_min_inliers: int = 15,
                 map_match_window: Optional[int] = None, reloc_fallback: bool = True,
                 fused: bool = True, new_cap: int = 256, match_metric: str = "L1",
                 device=None):
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float32)
        self.Kt = torch.from_numpy(self.K).to(self.device)
        self.cfg = cfg or SiftConfig()
        self.sift = SiftPlan(shape=frame_shape, config=self.cfg, device=self.device)
        self.min_boot_flow = min_boot_flow_px
        self.min_matches = min_matches
        self.reproj_px = reproj_px
        self.ba_every = ba_every
        # looser ratio than the pairwise default 0.5329: SfM matching is
        # outlier-gated downstream by RANSAC-PnP and reprojection checks
        self.ratio_sq = ratio_sq
        self.gen = torch.Generator(device="cpu").manual_seed(seed)
        # loop closure: re-match late frames against the oldest map points
        # (bootstrap-anchored, so drift-free up to gauge), turn accepted PnP
        # poses into pose-graph edges, optimize, and re-anchor the map
        self.loop_closure = loop_closure
        self.loop_min_inliers = loop_min_inliers
        # when set, sequential PnP matches only points first observed in the
        # last W cameras; global anchoring then comes from loop closure alone
        self.map_match_window = map_match_window
        # full-map retry when the windowed match starves (revisits)
        self.reloc_fallback = reloc_fallback
        # fused per-frame registration on the card; False: the host loop
        self.fused = fused
        self.new_cap = new_cap
        self.match_metric = match_metric
        self.n_loop_edges = 0
        self.n_detected = 0

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _buf(self, f: int) -> KeypointBuffer:
        """Frame f's keypoint buffer on the card, detected on first use."""
        if f not in self._bufs:
            self._bufs[f] = self.sift.keypoints_raw(np.asarray(self._frames[f], np.float32))
            self.n_detected += 1
        return self._bufs[f]

    def _kp_np(self, f: int) -> dict:
        """Frame f's compacted keypoints on the host ("x", "y", "desc")."""
        if f not in self._kps_cache:
            b = self._buf(f)
            m = b.valid.cpu().numpy()
            uv = torch.stack([b.x, b.y], -1).cpu().numpy()[m]
            self._kps_cache[f] = {"x": uv[:, 0], "y": uv[:, 1], "desc": b.desc.cpu().numpy()[m]}
        return self._kps_cache[f]

    def _match(self, d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
        """Ratio-test L1 matching of host descriptors, both sets padded to
        their ``_pow2_pad`` bucket (the JAX package's ``_match``): on a card
        one graph per bucket pair (``PAIR_GRAPHS``), its packed [idx1, idx2,
        valid] fetched in one copy; (M, 2) int indices."""
        n1, n2 = len(d1), len(d2)
        if n1 == 0 or n2 == 0:
            return np.zeros((0, 2), np.int32)
        p1, p2 = _pow2_pad(n1), _pow2_pad(n2)
        out = match_packed(_pad_rows(d1, p1, np.uint8), np.arange(p1) < n1,
                           _pad_rows(d2, p2, np.uint8), np.arange(p2) < n2, self.device,
                           ratio_sq=self.ratio_sq, cache=PAIR_GRAPHS).cpu().numpy()
        return out[out[:, 2] > 0][:, :2].astype(np.int32)

    def _boot_probe(self, chunk) -> np.ndarray:
        """Per candidate frame: the ratio-match count against frame 0 and
        the median matched displacement (the flow gate), (len(chunk), 2):
        the candidates' buffers stacked (``boot_probe``)."""
        b0, bufs = self._buf(0), [self._buf(b) for b in chunk]
        return boot_probe(b0.desc, b0.valid, torch.stack([b0.x, b0.y], -1),
                          torch.stack([b.desc for b in bufs]), torch.stack([b.valid for b in bufs]),
                          torch.stack([torch.stack([b.x, b.y], -1) for b in bufs]),
                          ratio_sq=self.ratio_sq).cpu().numpy()

    def _boot_pair(self, b: int):
        """Frame 0's ratio matches with frame b on the host's keypoints:
        (M, 2) indices and the matched points in each frame."""
        k0, kb = self._kp_np(0), self._kp_np(b)
        m = self._match(k0["desc"], kb["desc"])
        uv0 = np.stack([k0["x"][m[:, 0]], k0["y"][m[:, 0]]], 1)
        uvb = np.stack([kb["x"][m[:, 1]], kb["y"][m[:, 1]]], 1)
        return m, uv0, uvb

    def _bootstrap_fast(self, F: int):
        """Bootstrap pair: frame 0 against the first candidate passing both
        gates (matches and flow, probed on the card in chunks of 8 before
        any two-view init), else the best of inliers * flow."""
        gate = max(self.min_matches // 2, 10)
        best = (None, 0.0)      # (fallback, its score)
        low_flow = []           # (b, flow) failing only the flow gate
        cands = list(range(1, F))
        CH = 8
        for ci in range(0, len(cands), CH):
            chunk = cands[ci:ci + CH]
            for b, row in zip(chunk, self._boot_probe(chunk)):
                n_m, flow = int(row[0]), float(row[1])
                if n_m < gate:
                    continue
                if not np.isfinite(flow) or flow < self.min_boot_flow:
                    low_flow.append((b, flow))
                    continue
                boot, best = self._boot_try(b, flow, best)
                if boot is not None:
                    return boot
        return self._boot_fallback(low_flow, best)

    def _bootstrap(self, F: int):
        """The host loop's bootstrap pair, with ``_bootstrap_fast``'s gates,
        order and fallback: each candidate is matched on the host first and
        its flow gate (the median matched displacement) taken there."""
        gate = max(self.min_matches // 2, 10)
        best = (None, 0.0)
        low_flow = []
        for b in range(1, F):
            m, uv0, uvb = self._boot_pair(b)
            if len(m) < gate:
                continue
            flow = float(np.median(np.linalg.norm(uvb - uv0, axis=1)))
            if flow < self.min_boot_flow:
                low_flow.append((b, flow))
                continue
            boot, best = self._boot_try(b, flow, best)
            if boot is not None:
                return boot
        return self._boot_fallback(low_flow, best)

    def _boot_try(self, b: int, flow: float, best):
        """Two-view init of frame 0 with candidate b (its result on the
        host, sliced to the matches): (the candidate when it has
        min_matches inliers else None, and the (fallback, score) pair `best`
        updated with its score inliers * flow)."""
        m, uv0, uvb = self._boot_pair(b)
        init = self._run_two_view_init(m, uv0, uvb)
        n_inl = int(init.n_inliers)
        cand = (b, m, uv0, uvb, init)
        score = n_inl * flow
        if n_inl >= max(self.min_matches // 2, 10) and score > best[1]:
            best = (cand, score)
        return (cand if n_inl >= self.min_matches else None), best

    def _boot_fallback(self, low_flow, best):
        """No candidate passed both gates: the low-flow candidates are
        scored too, and the best of inliers * flow is the bootstrap (None
        when none passes the inlier gate)."""
        for b, flow in low_flow:
            _, best = self._boot_try(b, flow, best)
        return best[0]

    def _run_two_view_init(self, m, uv0, uvb):
        """The two-view init of the M matched pairs, padded to their
        ``_pow2_pad(M)`` bucket with a valid mask as the JAX package pads
        them.  Its result comes home in one copy, the points and inliers
        sliced to the M pairs."""
        n = len(m)
        P = _pow2_pad(n)
        init = initialize_two_view(self._next_seed(), self.Kt, _pad_rows(uv0, P, np.float32),
                                   _pad_rows(uvb, P, np.float32), np.arange(P) < n,
                                   thresh_px=self.reproj_px, device=self.device)
        R, t, X, inl, n_inl = graphs.to_host(init)
        return TwoViewInit(R, t, X[:n], inl[:n], n_inl)

    def _init_map_state(self, boot):
        """Host-side map and observation state from the bootstrap pair (its
        init on the host, sliced to the matches: ``_run_two_view_init``)."""
        b, m, uv0, uvb, init = boot
        kps = {0: self._kp_np(0), b: self._kp_np(b)}
        inl = init.inliers.numpy()
        map_X = init.points.numpy()[inl].astype(np.float32)
        map_desc = kps[0]["desc"][m[inl, 0]]
        obs_cam, obs_pt, obs_uv = [], [], []
        for pi, (i0, ib) in enumerate(m[inl]):
            obs_cam += [0, 1]
            obs_pt += [pi, pi]
            obs_uv += [[kps[0]["x"][i0], kps[0]["y"][i0]], [kps[b]["x"][ib], kps[b]["y"][ib]]]
        cam_of_frame = {0: 0, b: 1}
        Rs = [np.eye(3, dtype=np.float32), init.R.numpy().astype(np.float32)]
        ts = [np.zeros(3, np.float32), init.t.numpy().astype(np.float32)]
        pt_first_cam = np.zeros(len(map_X), np.int32)  # all bootstrap points
        return (map_X, map_desc, obs_cam, obs_pt, obs_uv, cam_of_frame, Rs, ts, [0, b],
                pt_first_cam)

    def run(self, frames, verbose: bool = False) -> Optional[SfMResult]:
        """Reconstruct `frames` (a sequence of (H, W) arrays); None when no
        bootstrap pair passes its gates."""
        F = len(frames)
        self._frames = frames
        self._bufs = {}
        self._kps_cache = {}
        self.n_detected = 0
        pt = self.phase_times = {"bootstrap": 0.0, "register": 0.0, "periodic_ba": 0.0,
                                 "loop_closure": 0.0, "final_ba": 0.0}
        t0 = time.perf_counter()
        if self.fused:
            boot = self._bootstrap_fast(F)
        else:
            for f in range(F):      # the host loop detects every frame first
                self._kp_np(f)
            boot = self._bootstrap(F)
        pt["bootstrap"] = time.perf_counter() - t0
        if boot is None:
            return None
        b, m, uv0, uvb, init = boot
        _say(verbose, "bootstrap: frames (0, %d), %d inliers", b, int(init.n_inliers))
        (map_X, map_desc, obs_cam, obs_pt, obs_uv, cam_of_frame,
         Rs, ts, frames_reg, pt_first_cam) = self._init_map_state(boot)
        register = self._register_fused if self.fused else self._register_host

        for f in sorted(f for f in range(1, F) if f != b):
            vrows = None
            if self.map_match_window is not None:
                vrows = pt_first_cam >= max(0, len(Rs) - self.map_match_window)
            t0 = time.perf_counter()
            ca = cam_of_frame[frames_reg[-1]]
            reg = register(f, vrows, map_desc, map_X, frames_reg[-1], Rs[ca], ts[ca], Rs[-1],
                           ts[-1], verbose)
            pt["register"] += time.perf_counter() - t0
            if reg.n_match < 12:
                _say(verbose, "frame %d: only %d map matches, skipped", f, reg.n_match)
                continue
            if reg.n_inl < 10:
                _say(verbose, "frame %d: PnP failed (%d inliers)", f, reg.n_inl)
                continue
            cam_id = len(Rs)
            cam_of_frame[f] = cam_id
            Rs.append(reg.R)
            ts.append(reg.t)
            frames_reg.append(f)
            # observations, and each inlier's descriptor refreshed to the
            # newest view so sequential matching tracks appearance drift
            obs_cam += [cam_id] * len(reg.rows)
            obs_pt += reg.rows.tolist()
            obs_uv += reg.uv.tolist()
            map_desc[reg.rows] = reg.desc
            # new landmarks, triangulated against the previous registered
            # frame (camera ca)
            n_new = len(reg.new_X)
            if n_new:
                base = len(map_X)
                map_X = np.concatenate([map_X, reg.new_X])
                map_desc = np.concatenate([map_desc, reg.new_desc])
                for k, (uvp, uvc) in enumerate(zip(reg.new_uv_prev.tolist(),
                                                   reg.new_uv_cur.tolist())):
                    obs_cam += [ca, cam_id]
                    obs_pt += [base + k, base + k]
                    obs_uv += [uvp, uvc]
                pt_first_cam = np.concatenate([pt_first_cam, np.full(n_new, ca, np.int32)])
            if len(Rs) % self.ba_every == 0:
                t0 = time.perf_counter()
                Rs, ts, map_X = self._run_ba(Rs, ts, map_X, obs_cam, obs_pt, obs_uv)
                pt["periodic_ba"] += time.perf_counter() - t0
            _say(verbose, "frame %d: cam %d, %d PnP inliers, map %d", f, cam_id, reg.n_inl,
                 len(map_X))

        if self.loop_closure and len(Rs) > 3:
            t0 = time.perf_counter()
            Rs, ts, map_X = self._pose_graph_close(frames_reg, cam_of_frame, Rs, ts, map_X,
                                                   map_desc, pt_first_cam, verbose)
            pt["loop_closure"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        Rs, ts, map_X = self._run_ba(Rs, ts, map_X, obs_cam, obs_pt, obs_uv, iters=25)
        pt["final_ba"] = time.perf_counter() - t0
        return SfMResult(Rs=np.stack(Rs), ts=np.stack(ts), points=map_X, n_obs=len(obs_cam),
                         frames_registered=frames_reg)

    def _register_fused(self, f, vrows, map_desc, map_X, prev_f, R_prev, t_prev, R0, t0,
                        verbose) -> "Registration":
        """Frame f through ``register_from_buffers`` against the map rows of
        `vrows` (None: all), retried against the whole map when a window
        starves (``reloc_fallback``)."""
        full = np.ones(len(map_X), bool)
        reg = self._register_frame(f, full if vrows is None else vrows, map_desc, map_X,
                                   prev_f, R_prev, t_prev, R0, t0)
        n_match = int(reg.n_match)
        # relocalization fallback: when windowed matching starves (a
        # revisit of old map points outside the window), retry against the
        # full map rather than drop the frame
        if n_match < 12 and vrows is not None and self.reloc_fallback and not vrows.all():
            reg2 = self._register_frame(f, full, map_desc, map_X, prev_f, R_prev, t_prev, R0, t0)
            if int(reg2.n_match) > n_match:
                _say(verbose, "frame %d: windowed match starved (%d), relocalizing vs "
                     "full map (%d)", f, n_match, int(reg2.n_match))
                reg = reg2
        rows, ok = np.nonzero(reg.inl)[0], reg.new_ok
        return Registration(int(reg.n_match), int(reg.n_inl), reg.R.astype(np.float32),
                            reg.t.astype(np.float32), rows, reg.uv[rows], reg.desc[rows],
                            reg.new_X[ok].astype(np.float32), reg.new_uv_prev[ok],
                            reg.new_uv_cur[ok], reg.new_desc[ok])

    def _register_host(self, f, vrows, map_desc, map_X, prev_f, R_prev, t_prev, R0, t0,
                       verbose) -> "Registration":
        """Frame f in the host loop: its compacted keypoints ratio-matched to
        the map rows of `vrows` (None: all; a starved window retried against
        the whole map), RANSAC-PnP from (R0, t0) on the matched rows, then
        ``_triangulate_new`` against prev_f at (R_prev, t_prev)."""
        kp = self._kp_np(f)
        if vrows is None:
            mm = self._match(map_desc, kp["desc"])
        else:
            sel = np.nonzero(vrows)[0]
            mm = self._match(map_desc[sel], kp["desc"])
            if len(mm):
                mm = np.stack([sel[mm[:, 0]], mm[:, 1]], 1)
            if len(mm) < 12 and self.reloc_fallback:
                mm_full = self._match(map_desc, kp["desc"])
                if len(mm_full) > len(mm):
                    _say(verbose, "frame %d: windowed match starved (%d), relocalizing vs "
                         "full map (%d)", f, len(mm), len(mm_full))
                    mm = mm_full
        if len(mm) < 12:
            return Registration(len(mm), 0)
        uv = np.stack([kp["x"][mm[:, 1]], kp["y"][mm[:, 1]]], 1)
        # the matched rows padded to their bucket (X = 0, uv = 0, w = 0), as
        # the JAX package's host loop pads them
        n = len(mm)
        P = _pow2_pad(n)
        R, t, inl, n_inl = (x.numpy() for x in graphs.to_host(ransac_pnp(
            self._next_seed(), self.Kt, R0, t0, _pad_rows(map_X[mm[:, 0]], P, np.float32),
            _pad_rows(uv, P, np.float32), _pad_rows(np.ones(n), P, np.float32),
            thresh_px=self.reproj_px)))
        if int(n_inl) < 10:
            return Registration(len(mm), int(n_inl))
        R, t, inl = R.astype(np.float32), t.astype(np.float32), inl[:n]
        new = self._triangulate_new(self._kp_np(prev_f), kp, R_prev, t_prev, R, t, mm[:, 1])
        return Registration(len(mm), int(n_inl), R, t, mm[inl, 0], uv[inl],
                            kp["desc"][mm[inl, 1]], *new)

    def _triangulate_new(self, kp_a: dict, kp_b: dict, Ra, ta, Rb, tb, used_b: np.ndarray):
        """New map points from the ratio matches of keypoints a (camera Ra,
        ta) and b (Rb, tb) whose keypoint in b is not in `used_b` (claimed
        by a map match): triangulated, kept where both depths exceed 1e-3
        and both reprojection errors are below ``reproj_px``.  Returns (X
        (n, 3), uv_a (n, 2), uv_b (n, 2), desc_b (n, 128)); none when
        fewer than 5 matches are fresh."""
        m = self._match(kp_a["desc"], kp_b["desc"])
        fresh = m[~np.isin(m[:, 1], used_b)]
        if len(fresh) < 5:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32),
                    np.zeros((0, 2), np.float32), np.zeros((0, 128), np.uint8))
        uva = np.stack([kp_a["x"][fresh[:, 0]], kp_a["y"][fresh[:, 0]]], 1)
        uvb = np.stack([kp_b["x"][fresh[:, 1]], kp_b["y"][fresh[:, 1]]], 1)
        Ra, ta, Rb, tb = (self._dev(np.asarray(a, np.float32)) for a in (Ra, ta, Rb, tb))
        X, z1, z2 = triangulate_two_view(self.Kt, Ra, ta, self.Kt, Rb, tb, self._dev(uva),
                                         self._dev(uvb))
        pa, _ = project(self.Kt, Ra, ta, X)
        pb, _ = project(self.Kt, Rb, tb, X)
        X, z1, z2, pa, pb = (x.cpu().numpy() for x in (X, z1, z2, pa, pb))
        ea = np.linalg.norm(pa - uva, axis=1)
        eb = np.linalg.norm(pb - uvb, axis=1)
        ok = (z1 > 1e-3) & (z2 > 1e-3) & (ea < self.reproj_px) & (eb < self.reproj_px)
        return X[ok].astype(np.float32), uva[ok], uvb[ok], kp_b["desc"][fresh[ok, 1]]

    def _register_frame(self, f, valid_rows, map_desc, map_X, prev_f, R_prev, t_prev, R0,
                        t0) -> RegisterOut:
        """Frame f's registration: its keypoints (detected on first use),
        the map (valid_rows: the match window) padded to its bucket
        (``_pow2_pad``, as the JAX package's ``fused_call``) and the
        previous registered frame prev_f (pose R_prev, t_prev) through
        ``register_from_buffers`` from (R0, t0) on the card; the result back
        on the host (NumPy, one copy from a replay), its map rows cut to the
        map's."""
        n = len(map_X)
        P = _pow2_pad(n)
        prev = self._buf(prev_f)
        out = RegisterOut(*(x.numpy() for x in graphs.to_host(register_from_buffers(
            self._buf(f), self._next_seed(), _pad_rows(map_desc, P, np.uint8),
            _pad_rows(valid_rows, P, bool), _pad_rows(map_X, P, np.float32), prev.desc,
            torch.stack([prev.x, prev.y], -1), prev.valid, R_prev, t_prev, R0, t0, self.K,
            new_cap=self.new_cap, ratio_sq=self.ratio_sq, reproj_px=self.reproj_px,
            metric=self.match_metric))))
        return out._replace(keep=out.keep[:n], inl=out.inl[:n], uv=out.uv[:n],
                            desc=out.desc[:n])

    def _loop_probe(self, cand, cams, old_desc, old_X, Rs, ts, draws=None) -> np.ndarray:
        """The fused path's loop-closure probe: every candidate frame's slots
        matched against the old map points, padded to ``_pow2_pad(n,
        floor=64)`` rows (zero descriptors and points, rows not valid) as
        the JAX package pads them, then RANSAC-PnP from the frame's camera
        (`cams`) pose, all in one call (``loop_probe``); rows [n_match,
        n_inl, R (9), t (3)].  ``draws``: the PnP draws over the padded
        rows, in place of those from a seed a candidate."""
        n = len(old_desc)
        Q = _pow2_pad(n, floor=64)
        seeds = torch.randint(0, 2 ** 62, (len(cand),), generator=self.gen).tolist()
        bufs = [self._buf(f) for f in cand]
        return loop_probe(
            torch.stack([b.desc for b in bufs]), torch.stack([b.valid for b in bufs]),
            torch.stack([torch.stack([b.x, b.y], -1) for b in bufs]),
            np.stack([Rs[c] for c in cams]), np.stack([ts[c] for c in cams]),
            _pad_rows(old_desc, Q, np.uint8), np.arange(Q) < n, _pad_rows(old_X, Q, np.float32),
            self.Kt, seeds, ratio_sq=self.ratio_sq, metric=self.match_metric,
            thresh_px=self.reproj_px, draws=draws).cpu().numpy()

    def _loop_edges_host(self, cand, cams, old_idx, map_desc, map_X, Rs, ts):
        """The host loop's loop-closure probe, frame by frame as the JAX
        package's host loop takes it: the frame's compacted keypoints
        ratio-matched to the old map points (``_match``), and where at least
        ``loop_min_inliers`` match, RANSAC-PnP from its pose on the matched
        rows padded to their bucket (``_pow2_pad``, w = 0).  Returns the
        accepted (camera, R, t)."""
        edges = []
        for f, c in zip(cand, cams):
            kp = self._kp_np(f)
            mm = self._match(map_desc[old_idx], kp["desc"])
            n = len(mm)
            if n < self.loop_min_inliers:
                continue
            P = _pow2_pad(n)
            uv = np.stack([kp["x"][mm[:, 1]], kp["y"][mm[:, 1]]], 1)
            R, t, _, n_inl = (x.numpy() for x in graphs.to_host(ransac_pnp(
                self._next_seed(), self.Kt, Rs[c], ts[c],
                _pad_rows(map_X[old_idx[mm[:, 0]]], P, np.float32), _pad_rows(uv, P, np.float32),
                _pad_rows(np.ones(n), P, np.float32), thresh_px=self.reproj_px)))
            if int(n_inl) >= self.loop_min_inliers:
                edges.append((c, R, t))
        return edges

    def _pose_graph_close(self, frames_reg, cam_of_frame, Rs, ts, map_X, map_desc,
                          pt_first_cam, verbose=False):
        """Loop closure and the pose graph.

        Each frame after the bootstrap pair is matched against the oldest
        map points (first observed by the bootstrap cameras, so in the
        gauge-fixed world frame: a PnP pose against them is a drift-free
        absolute measurement): on the fused path all candidates in one
        call (``_loop_probe``), in the host loop one at a time
        (``_loop_edges_host``).  Accepted PnP results become strong 0 -> c
        edges beside unit-weight odometry edges; after
        ``optimize_pose_graph`` every map point is re-anchored through its
        first-observing camera's correction."""
        C = len(Rs)
        old_mask = pt_first_cam <= 1
        if old_mask.sum() < 20:
            return Rs, ts, map_X
        old_idx = np.nonzero(old_mask)[0]
        R_old, t_old = np.stack(Rs), np.stack(ts)
        Rd, td = self._dev(R_old), self._dev(t_old)
        ZRs, Zts = (x.cpu().numpy() for x in relative_pose(Rd[:-1], td[:-1], Rd[1:], td[1:]))
        ei, ej = list(range(C - 1)), list(range(1, C))
        eZR, eZt = list(ZRs), list(Zts)
        ew = [1.0] * (C - 1)
        cand = [f for f in frames_reg if cam_of_frame[f] > 1]
        cams = [cam_of_frame[f] for f in cand]
        if self.fused:
            rows = self._loop_probe(cand, cams, map_desc[old_idx], map_X[old_idx], Rs, ts)
            edges = [(c, row[2:11].reshape(3, 3), row[11:14]) for row, c in zip(rows, cams)
                     if int(row[0]) >= self.loop_min_inliers
                     and int(row[1]) >= self.loop_min_inliers]
        else:
            edges = self._loop_edges_host(cand, cams, old_idx, map_desc, map_X, Rs, ts)
        for c, R, t in edges:
            # T_0 = I, so the absolute PnP pose is the 0 -> c edge transform
            ei.append(0)
            ej.append(c)
            eZR.append(R.astype(np.float32))
            eZt.append(t.astype(np.float32))
            ew.append(3.0)
        n_lc = self.n_loop_edges = len(edges)
        if n_lc == 0:
            return Rs, ts, map_X
        graph = PoseGraph(i=self._dev(np.asarray(ei, np.int32)),
                          j=self._dev(np.asarray(ej, np.int32)),
                          Z_R=self._dev(np.stack(eZR)), Z_t=self._dev(np.stack(eZt)),
                          w=self._dev(np.asarray(ew, np.float32)))
        free = self._dev((np.arange(C) > 0).astype(np.float32))
        Rn, tn, cost = (x.numpy() for x in graphs.to_host(
            optimize_pose_graph(Rd, td, graph, free, iters=20, huber=10.0)))
        self._pgo_debug = (R_old, t_old, Rn, tn,
                           [np.stack(eZR[C - 1:]), np.stack(eZt[C - 1:]), ej[C - 1:]])
        _say(verbose, "pose graph: %d loop edges, cost %.4f", n_lc, float(cost))
        # re-anchor map points through their first-observing camera:
        # X' = R_new_a^T (R_old_a X + t_old_a - t_new_a)
        a = np.clip(pt_first_cam, 0, C - 1)
        Xc = np.einsum("pij,pj->pi", R_old[a], map_X) + t_old[a]
        map_X = np.einsum("pji,pj->pi", Rn[a], Xc - tn[a]).astype(np.float32)
        return [Rn[i] for i in range(C)], [tn[i] for i in range(C)], map_X

    def _run_ba(self, Rs, ts, map_X, obs_cam, obs_pt, obs_uv, iters: int = 12):
        """`iters` LM iterations (``run_ba``: the scatter form, CG, camera 0
        fixed, lam0 1e-3) over the whole map, padded as the JAX package's
        ``_run_ba`` pads it: the observations to ``_pow2_pad(M)`` rows (uv
        0, cam 0, pt 0, w 0) and the points to ``_pow2_pad(P)`` (X 0), so
        that on a card every iteration of a call replays one graph
        (``ba.LM_GRAPHS``); Rs, ts and X come home in one copy."""
        C, P, M = len(Rs), len(map_X), len(obs_cam)
        Mp, Pp = _pow2_pad(M), _pow2_pad(P)
        params = BAParams(self._dev(np.stack(Rs).astype(np.float32)),
                          self._dev(np.stack(ts).astype(np.float32)),
                          self._dev(_pad_rows(map_X, Pp, np.float32)))
        obs = BAObs(self._dev(_pad_rows(obs_uv, Mp, np.float32)),
                    self._dev(_pad_rows(obs_cam, Mp, np.int32)),
                    self._dev(_pad_rows(obs_pt, Mp, np.int32)),
                    self._dev(_pad_rows(np.ones(M), Mp, np.float32)))
        params, _ = run_ba(params, obs, self.Kt, fixed_cams=(0,), iters=iters,
                           huber_px=self.reproj_px, cg_iters=30, fetch_costs=False)
        Rs_np, ts_np, X_np = (x.numpy() for x in graphs.to_host(params))
        return list(Rs_np), list(ts_np), X_np[:P]

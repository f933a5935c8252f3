"""The entries into the port that a traffic mix drives, by its ``entry``:

* ``vo_stream``: ``vo_init``, then ``vo_step`` on crops of one seeded scene
  that pan ``pan_px`` a frame back and forth over ``positions`` places;
  each step's ``VOOut`` is copied home;
* ``video_frontend``: ``VideoSiftFrontend(shape, batch)`` on batches drawn
  from a seeded pool of scenes; each batch's keypoint buffer is copied home;
* ``sift_plan``: ``SiftPlan(shape).keypoints`` on images of a seeded pool,
  one synchronous call an image (host image in, keypoint records out).

Every frame enters as a uint8 host array.  An entry hands units (a frame
or a batch) to the program (``submit``), waits for a unit's result in host
memory (``fetch``), keeps a seeded sample of the window's units for the
check against the reference (``keep``), and states what the bound files
count from (``facts``).  Only this module imports the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, scenes, trace

STATE_FIELDS = ("Rs", "ts", "X", "Xvalid", "Xdesc", "obs_uv", "obs_pt", "obs_w", "prev_desc",
                "prev_uv", "prev_valid", "key_desc", "key_uv", "key_valid", "key_R", "key_t",
                "key_frame", "tri_par", "lam", "frame")
BUF_FIELDS = ("x", "y", "scale", "angle", "desc", "valid", "counts")


def sigma_range(params) -> tuple:
    """Octave-local sigma of a refined keypoint: fs in [0.5, scales + 0.5]."""
    s0, n = params.init_sigma, params.scales
    return s0 * 2.0 ** (0.5 / n), s0 * 2.0 ** ((n + 0.5) / n)


class Reservoir:
    """A uniform sample of `k` of a stream of unknown length, drawn from
    the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 7])

    def offer(self) -> Optional[int]:
        """The slot the next item goes to, or None where it is not kept."""
        i, self.n = self.n, self.n + 1
        if i < self.k:
            self.items.append(None)
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)


class _Unit:
    __slots__ = ("index", "t_in", "t_done", "host", "event", "sample", "extra")

    def __init__(self, index):
        self.index, self.t_in, self.t_done = index, None, None
        self.host = self.event = self.sample = self.extra = None


class Entry:
    """What the three entries share: the cell's config and the seed."""

    frames_per_unit = 1

    def __init__(self, cell, seed: int, device: torch.device, shape=None):
        import sift_pyocl_tpu_torch as port

        self.port = port
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.shape = tuple(shape or cell.config["shape"])
        self.cfg = port.SiftConfig(**cell.config["sift"])
        self.sample = Reservoir(int(cell.traffic["check_units"]), seed)
        self.n_units = 0
        self.spans = trace.Spans()

    def caches(self) -> List:
        raise NotImplementedError

    def captures(self) -> int:
        return sum(c.captures for c in self.caches())

    def _keep(self, unit: _Unit, value) -> None:
        slot = self.sample.offer()
        if slot is not None:
            self.sample.items[slot] = value


class VOStream(Entry):
    def __init__(self, cell, seed, device, shape=None):
        super().__init__(cell, seed, device, shape)
        tr = cell.traffic
        h, w = self.shape
        self.vo = self.port.VOConfig(**cell.config["vo"])
        pan, npos = int(tr["pan_px"]), int(tr["positions"])
        margin = int(tr["margin_px"])
        big = scenes.scenes(1, (h + 2 * margin, w + 2 * margin + pan * (npos - 1)),
                            int(tr["n_blobs"]), seed, self.device)[0].cpu().numpy()
        self.frames = [np.ascontiguousarray(big[margin:margin + h,
                                                margin + pan * i:margin + pan * i + w])
                       for i in range(npos)]
        self.order = list(range(npos)) + list(range(npos - 2, 0, -1))
        k = cell.config["intrinsics"]
        sy, sx = h / cell.config["shape"][0], w / cell.config["shape"][1]
        self.K = np.array([[k["fx"] * sx, 0.0, k["cx"] * sx], [0.0, k["fy"] * sy, k["cy"] * sy],
                           [0.0, 0.0, 1.0]], np.float32)
        self.state = None
        self.slots = []

    def caches(self):
        from sift_pyocl_tpu_torch.models import vo as vo_mod
        return [vo_mod.STEP_GRAPHS]

    def frame_at(self, n: int) -> np.ndarray:
        return self.frames[self.order[n % len(self.order)]]

    def start(self) -> None:
        self.state = self.port.vo_init(self.frame_at(0), self.K, self.cfg, self.vo,
                                       device=self.device)
        self.n_units = 1

    def submit(self, unit: _Unit, keep: bool, trace_keep: bool) -> None:
        n = self.n_units
        self.n_units += 1
        frame = self.frame_at(n)
        before = self.state
        with self.spans("api"):
            self.state, out = self.port.vo_step(before, frame, self.K, self.cfg, self.vo)
        with self.spans("copy"):
            packed = torch.cat([f.reshape(-1).view(torch.uint8) for f in out])
            if len(self.slots) < 4:
                self.slots.append(_pinned_like(packed))
            unit.host = self.slots[unit.index % len(self.slots)]
            unit.host.copy_(packed, non_blocking=True)
            unit.event = torch.cuda.Event() if packed.is_cuda else None
            if unit.event is not None:
                unit.event.record()
        if keep:
            self._keep(unit, (n, before, self.state, out))
        if trace_keep:
            unit.extra = (before, self.state, out)

    def fetch(self, unit: _Unit) -> None:
        if unit.event is not None:
            unit.event.synchronize()

    def check(self, control: bool = False) -> Dict[str, float]:
        """The sampled steps against the reference, worst over the sample:
        the step's keypoints against the reference's frontend on the same
        frame; then its back end (matches, PnP, roll and spawn, BA) against
        the reference's back end from the same state on the program's own
        keypoints.  ``control``: the reference in bfloat16 (``lower``) in
        the program's place."""
        from ..reference import sift as rsift, vo as rvo

        p = rsift.Params.from_dict(self.cell.config["sift"])
        vp = rvo.VOParams.from_dict(self.cell.config["vo"])
        K = torch.as_tensor(self.K, device=self.device)
        worst: Dict[str, float] = {}
        for n, before, after, out in self.sample.items:
            frame = torch.from_numpy(self.frame_at(n)).to(self.device)
            start = dict(zip(STATE_FIELDS, before))
            rbuf = rsift.detect_and_describe(frame, p)
            if control:
                got, gout, gbuf = rvo.vo_step(start, frame, K, p, vp, lower=True)
                scale = gbuf.scale
            else:
                got, gout = dict(zip(STATE_FIELDS, after)), out._asdict()
                scale = None
            kp = {"x": got["prev_uv"][:, 0], "y": got["prev_uv"][:, 1],
                  "desc": got["prev_desc"], "valid": got["prev_valid"]}
            nums = compare.keypoint_gaps(kp, {"x": rbuf.x, "y": rbuf.y, "desc": rbuf.desc,
                                              "valid": rbuf.valid})
            nums["ref_keypoints"] = float(rbuf.valid.sum())
            if scale is None:
                scale = compare.matched_scale(kp, rbuf._asdict())
            kbuf = rbuf._replace(x=kp["x"], y=kp["y"], desc=kp["desc"], valid=kp["valid"],
                                 scale=scale)
            ref, rout, _ = rvo.vo_step(start, frame, K, p, vp, keypoints=kbuf)
            nums.update(vo_gaps(K, vp, got, gout, ref, rout))
            for k, v in nums.items():
                worst[k] = (min if k == "ref_keypoints" else max)(worst.get(k, v), v)
        return worst

    def facts(self, unit: _Unit) -> List[dict]:
        """What a traced step's kernels work on: per frame slot its octave
        (the valid slots of the frame's buffer) and the two K7 calls'
        valid rows and columns."""
        before, after, out = unit.extra
        caps = _caps(self.shape, self.cfg)
        mo = self.cfg.max_ori
        octave = torch.repeat_interleave(torch.arange(len(caps)),
                                         torch.tensor(caps) * mo)
        valid = after.prev_valid.cpu()
        kp = valid.reshape(-1, mo).any(1)
        W = self.vo.window
        return [{"shape": self.shape, "cfg": self.cfg, "caps": caps,
                "kp_octave": octave[::mo][kp].numpy(), "kp_sigma": None,
                "n_slots_ok": int(valid.sum()),
                "k7": [(valid.numel(), int(valid.sum()), after.Xdesc.numel() // 128,
                        int((before.Xvalid > 0).sum())),
                       (self.vo.pts_per_frame, int((after.Xvalid[W - 1] > 0).sum()),
                        before.key_valid.numel(), int(before.key_valid.sum()))]}]


ROLLED = ("Xvalid", "Xdesc", "obs_uv", "obs_pt", "obs_w")


def vo_gaps(K, vp, got: dict, gout: dict, ref: dict, rout: dict) -> Dict[str, float]:
    """A VO step's back end against the reference's on the same state and
    keypoints.  matches: the match count, relative; tracked_flips: the
    tracking flag; rms_px: PnP's inlier RMS; ba_cost: the BA's robust cost
    at its input (the PnP pose, the matched observations, the spawned and
    refreshed points), relative; roll_gap: the window's carried part (the
    two cameras the BA holds, the older frames' points' flags and
    descriptors and their observations), exact; ba_fit_px: where the BA's
    output puts each camera's observations (``compare.fit_gap``) against
    the nearer of the reference's BA input and proposed step, so that an
    iteration accepted on one side and refused on the other compares
    alike; ba_rise: the robust cost of the program's output window over
    that of the reference's BA input, relative, which an accepted LM
    iteration never raises.  Printed only: the poses, which the gauge of a
    short window leaves ill-determined, and spawn_tri, the count of spawned
    points that passed the parallax gate (PERF.md section 6)."""
    from ..reference import vo as rvo

    W = vp.window
    nums = compare.pose_gaps(got["Rs"], got["ts"], ref["Rs"], ref["ts"])
    nums["rms_px"] = abs(float(gout["rms_px"]) - float(rout["rms_px"]))
    c_r = float(rout["ba_cost"])
    nums["ba_cost"] = abs(float(gout["ba_cost"]) - c_r) / max(c_r, 1e-12)
    nr = float(rout["n_matches"])
    nums["matches"] = abs(float(gout["n_matches"]) - nr) / max(nr, 1.0)
    nums["spawn_tri"] = abs(float(gout["n_spawn_tri"]) - float(rout["n_spawn_tri"]))
    tracked = bool(rout["tracked"])
    nums["tracked_flips"] = float(bool(gout["tracked"]) != tracked)
    held = slice(0, 2) if tracked else slice(0, W)
    gaps = [(got[k][held].double() - ref[k][held].double()).abs().max() for k in ("Rs", "ts")]
    gaps += [(got[k][:W - 1].double() - ref[k][:W - 1].double()).abs().max() for k in ROLLED]
    nums["roll_gap"] = float(torch.stack(gaps).max())
    P = ref["X"].shape[0] * ref["X"].shape[1]
    pt = ref["obs_pt"].reshape(-1)
    obs = (ref["obs_uv"].reshape(-1, 2),
           torch.arange(W, device=pt.device).repeat_interleave(vp.obs_per_frame), pt,
           ref["obs_w"].reshape(-1) * ref["Xvalid"].reshape(-1)[pt.long()])
    cands = [rout["ba_input"], rout["ba_proposal"]] if tracked else \
        [(ref["Rs"], ref["ts"], ref["X"].reshape(P, 3))]
    nums["ba_fit_px"] = min(compare.fit_gap(K, ((got["Rs"], got["ts"]), (Rs, ts)),
                                            (got["X"].reshape(P, 3), X), obs)
                            for Rs, ts, X in cands)
    Rs, ts, X = cands[0]
    c_in = rvo.window_cost(dict(ref, Rs=Rs, ts=ts, X=X), K, vp)
    nums["ba_rise"] = (rvo.window_cost(got, K, vp) - c_in) / max(c_in, 1e-12)
    return nums


def _caps(shape, cfg) -> List[int]:
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    return [c for c, _ in octave_capacities(shape, cfg)]


def _record_facts(shape, cfg, x, y, scale) -> dict:
    """Facts from keypoint records: each keypoint's octave and
    octave-local sigma from its scale (the local sigma spans less than one
    octave), one keypoint per distinct (x, y, octave)."""
    lo, _ = sigma_range(cfg)
    base = 0.5 if cfg.double_im_size else 1.0
    octave = np.floor(np.log2(np.asarray(scale, np.float64) / (lo * base)) + 1e-6).astype(int)
    octave = np.clip(octave, 0, None)
    keys = np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64), octave], 1)
    _, first = np.unique(keys, axis=0, return_index=True)
    local = np.asarray(scale, np.float64) / (base * 2.0 ** octave)
    return {"shape": shape, "cfg": cfg, "caps": _caps(shape, cfg),
            "kp_octave": octave[first], "kp_sigma": local[first], "n_slots_ok": len(x),
            "k7": []}


class VideoFrontend(Entry):
    def __init__(self, cell, seed, device, shape=None):
        super().__init__(cell, seed, device, shape)
        tr = cell.traffic
        self.batch = int(tr["batch"])
        self.frames_per_unit = self.batch
        pool = scenes.scenes(int(tr["pool"]), self.shape, int(tr["n_blobs"]), seed,
                             self.device).cpu().numpy()
        rng = np.random.default_rng([self.seed % 2 ** 63, 3])
        self.ids = [rng.choice(len(pool), self.batch, replace=False)
                    for _ in range(int(tr["batches"]))]
        self.batches = [np.ascontiguousarray(pool[i]) for i in self.ids]
        from sift_pyocl_tpu_torch.parallel import VideoSiftFrontend, make_frames_mesh
        self.fe = VideoSiftFrontend(self.shape, self.batch, cfg=self.cfg,
                                    mesh=make_frames_mesh(devices=[self.device]))
        self.slots = []

    def caches(self):
        from sift_pyocl_tpu_torch.models import sift as sift_mod
        return [sift_mod.DETECT_GRAPHS]

    def start(self) -> None:
        self.n_units = 0

    def submit(self, unit: _Unit, keep: bool, trace_keep: bool) -> None:
        n = self.n_units
        self.n_units += 1
        with self.spans("api"):
            buf = self.fe(self.batches[n % len(self.batches)])
        with self.spans("copy"):
            if len(self.slots) < 4:
                self.slots.append([_pinned_like(t) for t in buf])
            unit.host = self.slots[unit.index % len(self.slots)]
            for h, t in zip(unit.host, buf):
                h.copy_(t, non_blocking=True)
            unit.event = torch.cuda.Event() if buf.x.is_cuda else None
            if unit.event is not None:
                unit.event.record()
        unit.sample = (keep, trace_keep, n % len(self.batches))

    def fetch(self, unit: _Unit) -> None:
        if unit.event is not None:
            unit.event.synchronize()
        keep, trace_keep, b = unit.sample
        if keep:
            f = int(self.sample.rng.integers(0, self.batch))
            self._keep(unit, (int(self.ids[b][f]), {k: unit.host[i][f].clone()
                                                     for i, k in enumerate(BUF_FIELDS)}))
        if trace_keep:
            unit.extra = [{k: unit.host[i][f].clone() for i, k in enumerate(BUF_FIELDS)}
                          for f in range(self.batch)]

    def pool_frame(self, pid: int) -> np.ndarray:
        for ids, arr in zip(self.ids, self.batches):
            hit = np.nonzero(ids == pid)[0]
            if hit.size:
                return arr[hit[0]]
        raise KeyError(pid)

    def check(self, control: bool = False) -> Dict[str, float]:
        return _check_frames(self, [(self.pool_frame(pid), buf)
                                    for pid, buf in self.sample.items], control)

    def facts(self, unit: _Unit) -> List[dict]:
        return [_record_facts(self.shape, self.cfg, *(b[k][b["valid"]].numpy()
                                                      for k in ("x", "y", "scale")))
                for b in unit.extra]


class SiftPlanSingle(Entry):
    def __init__(self, cell, seed, device, shape=None):
        super().__init__(cell, seed, device, shape)
        tr = cell.traffic
        self.pool = scenes.scenes(int(tr["pool"]), self.shape, int(tr["n_blobs"]), seed,
                                  self.device).cpu().numpy()
        rng = np.random.default_rng([self.seed % 2 ** 63, 5])
        self.order = rng.permutation(len(self.pool))
        self.plan = self.port.SiftPlan(self.shape, dtype="uint8", config=self.cfg,
                                       device=self.device)

    def caches(self):
        from sift_pyocl_tpu_torch.models import sift as sift_mod
        return [sift_mod.DETECT_GRAPHS]

    def start(self) -> None:
        self.n_units = 0

    def submit(self, unit: _Unit, keep: bool, trace_keep: bool) -> None:
        n = self.n_units
        self.n_units += 1
        pid = int(self.order[n % len(self.order)])
        with self.spans("api"):
            recs = self.plan.keypoints(self.pool[pid])
        unit.host = recs
        if keep:
            self._keep(unit, (pid, {"x": torch.from_numpy(recs["x"]),
                                    "y": torch.from_numpy(recs["y"]),
                                    "scale": torch.from_numpy(recs["scale"]),
                                    "angle": torch.from_numpy(recs["angle"]),
                                    "desc": torch.from_numpy(recs["desc"]),
                                    "valid": torch.ones(len(recs), dtype=torch.bool)}))
        if trace_keep:
            unit.extra = recs

    def fetch(self, unit: _Unit) -> None:
        pass

    def check(self, control: bool = False) -> Dict[str, float]:
        return _check_frames(self, [(self.pool[pid], buf) for pid, buf in self.sample.items],
                             control)

    def facts(self, unit: _Unit) -> List[dict]:
        r = unit.extra
        return [_record_facts(self.shape, self.cfg, r["x"], r["y"], r["scale"])]


def _check_frames(entry: Entry, pairs, control: bool) -> Dict[str, float]:
    """Sampled frames' keypoints against the reference's on the same image:
    worst over the sample.  ``control``: the reference in bfloat16
    (``lower``) in the program's place."""
    from ..reference import sift as rsift

    p = rsift.Params.from_dict(entry.cell.config["sift"])
    worst: Dict[str, float] = {}
    for img, buf in pairs:
        x = torch.from_numpy(img).to(entry.device)
        ref = rsift.detect_and_describe(x, p)
        if control:
            buf = rsift.detect_and_describe(x, p, lower=True)._asdict()
        got = {k: v.to(entry.device) for k, v in buf.items() if k != "counts"}
        nums = compare.keypoint_gaps(got, ref._asdict())
        nums["ref_keypoints"] = float(ref.valid.sum())
        for k, v in nums.items():
            worst[k] = (min if k == "ref_keypoints" else max)(worst.get(k, v), v)
    return worst


ENTRIES = {"vo_stream": VOStream, "video_frontend": VideoFrontend, "sift_plan": SiftPlanSingle}


def make(cell, seed: int, device, shape=None) -> Entry:
    return ENTRIES[cell.traffic["entry"]](cell, seed, device, shape)


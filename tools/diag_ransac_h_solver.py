"""Where phase G's corner error comes from: RANSAC-H under K12 and under eigh.

    python tools/diag_ransac_h_solver.py [--out chiprun_out/diag_ransac_h_solver.json]

Runs chip_smoke.py's phase G sequence (config 2: 8 crops of a 1144x1984
synthetic scene, 1080x1920 each, moving by CONFIG2_STEP a frame; each frame
detected with the kernel path, ratio-matched to the previous frame's buffer
with L2, then RANSAC-H with the frame's index as seed) on a CUDA card, and
for each frame takes ``ransac_homography``'s steps apart twice: once with
``sfm.geometry._smallest_eigvec`` on K12 (``sym_eig_small``, the main
path) and once on its plain version (``torch.linalg.eigh`` on the card).
Per frame and solver it reports the winning hypothesis, its score and the
runner-up scores, whether the refit was kept, the final inlier count and
the corner error of the raw winner, of the refit and of the result (the
result held bit for bit to ``ransac_homography``'s under that solver).
To split the solver's share from the winner's, it then refits each
solver's final inlier set under both solvers, in float64 on the host, and
from float64's null vector of the same float32 A^T A; and it gives each
float32 solver's distance from that float64 null vector, 1 - |cos|.

Prints one JSON object (also written to ``--out``) with the card's
``nvidia-smi`` name and power limit.  Requires a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe  # noqa: E402
from sift_pyocl_tpu_torch.ops.kernels import linalg  # noqa: E402
from sift_pyocl_tpu_torch.ops.match import match_descriptors_dense  # noqa: E402
from sift_pyocl_tpu_torch.sfm import geometry as tg  # noqa: E402
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene  # noqa: E402

tr = importlib.import_module("sift_pyocl_tpu_torch.sfm.ransac")  # the package's name is a function

THRESH = 3.0 ** 2          # ransac_homography's default thresh_px, squared
MIN_SAMPLES = 4
SOLVERS = {"K12": linalg.sym_eig_small,
           "eigh": functools.partial(linalg.sym_eig_small, plain=True)}


def corner(H, dy, dx) -> float:
    return cs.corner_error(H.detach().double().cpu().numpy(), cs.SHAPE, dy, dx)


def h_from_null(h, T1, T2) -> torch.Tensor:
    """H = T2^-1 h T1 with H[2, 2] = 1, in float64 on the host."""
    h, T1, T2 = (x.detach().double().cpu() for x in (h.reshape(3, 3), T1, T2))
    H = torch.linalg.inv(T2) @ h @ T1
    return H / H[2, 2]


def ransac_steps(uv1, uv2, keep, rows, dy, dx) -> dict:
    """ransac()'s steps for RANSAC-H on `rows`, with what it keeps inside."""
    models = tg.fit_homography(uv1, uv2, rows)
    inl = (tg.homography_error(models, uv1, uv2) < THRESH) & keep[None, :]
    scores = inl.sum(1, dtype=torch.int32)
    best = int(tg._first_argmax(scores))
    best_in, best_score = inl[best], int(scores[best])
    refit_w = best_in.float() if best_score >= MIN_SAMPLES else rows[best]
    refit = tg.fit_homography(uv1, uv2, refit_w[None])[0]
    final_in = (tg.homography_error(refit[None], uv1, uv2)[0] < THRESH) & keep
    use_refit = int(final_in.sum()) >= best_score
    model = refit if use_refit else models[best]
    inliers = final_in if use_refit else best_in
    order = torch.argsort(scores.cpu(), descending=True, stable=True)[:5]
    return {"winner": best, "winner_score": best_score,
            "top5": [[int(i), int(scores[i])] for i in order],
            "ties_at_top": int((scores == scores.max()).sum()),
            "refit_kept": bool(use_refit), "n_inliers": int(inliers.sum()),
            "corner_px_winner": corner(models[best], dy, dx),
            "corner_px_refit": corner(refit, dy, dx),
            "corner_px_result": corner(model, dy, dx),
            "_model": model, "_inliers": inliers}


def refits_of(uv1, uv2, inliers, dy, dx) -> dict:
    """One inlier set refit by each float32 solver, in float64, and from
    float64's null vector of the same float32 A^T A."""
    w = inliers.float()[None]
    out = {}
    for name, fn in SOLVERS.items():
        tg.sym_eig_small = fn
        out[f"corner_px_{name}"] = corner(tg.fit_homography(uv1, uv2, w)[0], dy, dx)
    tg.sym_eig_small = linalg.sym_eig_small
    H64 = tg.fit_homography(uv1.double().cpu(), uv2.double().cpu(), w.double().cpu())[0]
    out["corner_px_f64_fit"] = corner(H64, dy, dx)
    AtA, T1, T2 = tg._dlt_normal(uv1, uv2, w)
    lam, V64 = torch.linalg.eigh(AtA[0].double().cpu())
    out["corner_px_f64_null_of_f32_AtA"] = corner(h_from_null(V64[:, 0], T1[0], T2[0]), dy, dx)
    out["eig_gap_rel"] = float((lam[1] - lam[0]) / lam[-1])
    for name, fn in SOLVERS.items():
        v = fn(AtA)[1][0, :, 0].double().cpu()
        out[f"null_1_minus_cos_{name}"] = float(1 - abs(v @ V64[:, 0]) / v.norm())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/diag_ransac_h_solver.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    cfg = SiftConfig()
    base = synthetic_scene(cs.API_SCENE, n_blobs=200, seed=0)
    dy, dx = cs.CONFIG2_STEP
    bufs = [detect_and_describe(torch.from_numpy(cs.api_crop(base, i * dy, i * dx)).to(dev), cfg)
            for i in range(cs.CONFIG2_SEQ_FRAMES)]
    frames = []
    for i in range(1, cs.CONFIG2_SEQ_FRAMES):
        b, prev = bufs[i], bufs[i - 1]
        keep, mid, _, _ = match_descriptors_dense(b.desc, b.valid, prev.desc, prev.valid,
                                                  metric="L2", ratio_sq=cs.CONFIG2_RATIO_SQ)
        uv1 = torch.stack([b.x, b.y], -1)
        uv2 = torch.stack([prev.x, prev.y], -1)[mid.long()]
        rows = tr._sample_weights(i, keep, 256, MIN_SAMPLES)
        row = {"frame": i, "matches": int(keep.sum())}
        for name, fn in SOLVERS.items():
            tg.sym_eig_small = fn
            got = ransac_steps(uv1, uv2, keep, rows, dy, dx)
            want = tr.ransac_homography(i, uv1, uv2, keep)
            assert torch.equal(got["_model"], want.model), (i, name)
            assert torch.equal(got["_inliers"], want.inliers), (i, name)
            row[name] = got
        tg.sym_eig_small = linalg.sym_eig_small
        k, e = row["K12"], row["eigh"]
        row["same_winner"] = k["winner"] == e["winner"]
        row["same_inliers"] = bool(torch.equal(k["_inliers"], e["_inliers"]))
        for name in SOLVERS:
            row[f"refits_of_{name}_inliers"] = refits_of(uv1, uv2, row[name]["_inliers"], dy, dx)
        for name in SOLVERS:
            del row[name]["_model"], row[name]["_inliers"]
        frames.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": card.strip(), "frames": frames}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(card.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

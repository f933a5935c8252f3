"""The JAX package's own outcomes on the sequences that chip_smoke.py's
phases C and H gate the port on, run once on the CPU (the port's gates
are taken from them; the JAX package never runs on the card).

    JAX_PLATFORMS=cpu python tools/jax_cpu_references.py [host] [cli]

host: IncrementalSfM(fused=False) over config 4's 50 frames
      (tools/bench_configs.py::config4_sfm's sequence and settings):
      registered frames, ATE, map points, loop edges, bootstrap frame.
cli:  config 4's frames written as PGM + TUM (evaluate.save_sequence) and
      `python -m sift_pyocl_tpu.evaluate` over them in vo and sfm mode.

The 200-frame fence's JAX numbers come from
`python -m pytest -m slow tests/test_vo_longrun.py -s`.  Prints one JSON
line a result.
"""

import io
import json
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from sift_pyocl_tpu import SiftConfig  # noqa: E402
from sift_pyocl_tpu.evaluate import main as evaluate_main, save_sequence  # noqa: E402
from sift_pyocl_tpu.sfm.evaluate import ate_rmse, camera_centers  # noqa: E402
from sift_pyocl_tpu.sfm.pipeline import IncrementalSfM  # noqa: E402
from sift_pyocl_tpu.utils.render3d import render_sequence  # noqa: E402

CONFIG4_SEQ = dict(n_frames=50, n_points=120, image_size=(320, 240), seed=0, arc_deg=40.0)


def host_loop(K, frames, gtR, gtT) -> dict:
    sfm = IncrementalSfM(K, frames[0].shape, cfg=SiftConfig(kp_per_octave_cap=256), ba_every=8,
                         fused=False)
    t = time.perf_counter()
    res = sfm.run(frames)
    reg = res.frames_registered
    ate = ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg]))
    return {"host_loop": {"registered": len(reg), "ate": float(ate),
                          "points": int(len(res.points)), "loop_edges": sfm.n_loop_edges,
                          "bootstrap": reg[1], "cpu_wall_s": time.perf_counter() - t}}


def cli(K, frames, gtR, gtT) -> dict:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        seq, gt = save_sequence(tmp + "/seq", frames, gtR, gtT)
        for mode in ("vo", "sfm"):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = evaluate_main(["--frames", str(seq), "--gt", str(gt), "--mode", mode,
                                    "--fx", str(float(K[0, 0]))])
            out[f"cli_{mode}"] = {"rc": rc, **json.loads(buf.getvalue().strip().splitlines()[-1])}
    return out


def main() -> int:
    which = sys.argv[1:] or ["host", "cli"]
    K, frames, gtR, gtT = render_sequence(**CONFIG4_SEQ)
    for name, fn in (("host", host_loop), ("cli", cli)):
        if name in which:
            print(json.dumps(fn(K, frames, gtR, gtT)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

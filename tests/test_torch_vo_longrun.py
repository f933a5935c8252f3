"""The 200-frame VO fence through the port on the CPU
(tests/test_vo_longrun.py's scene, settings and bounds;
``sift_pyocl_tpu_torch/utils/longrun.py`` holds them).

``vo_step._cache_size()`` (no recompiles after warm-up) has no eager
counterpart; in its place the run holds the kernel library's builds and
loads (``ops/_build.py::build_counts``) and the carried state's shapes and
dtypes fixed after frame 2.
"""

import numpy as np
import pytest
import torch

from sift_pyocl_tpu.utils.testimage import blob_cloud as j_blob_cloud
from sift_pyocl_tpu.utils.testimage import render_point_cloud as j_render

from sift_pyocl_tpu_torch.utils import longrun
from _torch_threads import _one_torch_thread  # noqa: F401


def test_fence_frames_are_the_reference_scene():
    """Frames 0, 37 and 199 equal the reference test's renders bit for bit."""
    pts, radii, amps = j_blob_cloud(n=150, seed=5, depth=(3.5, 8.5), span=4.5)
    K = [[280.0, 0, 224 / 2], [0, 280.0, 224 / 2], [0, 0, 1.0]]
    got = longrun.render_frames((0, 37, 199))
    for g, i in zip(got, (0, 37, 199)):
        want = j_render(pts, radii, amps, K, np.eye(3, dtype=np.float32),
                        -longrun.center_at(i), (224, 224))
        np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(longrun.K, np.asarray(K, np.float32))


@pytest.mark.slow
def test_vo_200_frame_stability():
    r = longrun.run(device="cpu")
    print(f"[vo-longrun, port, cpu] tracked {r['tracked']:.3f}, ATE {r['ate']:.4f}, "
          f"path_ratio {r['path_ratio']:.2f} over {r['frames']} frames, "
          f"{np.median(r['step_s'][longrun.WARM:]) * 1e3:.1f} ms a step (median), "
          f"RSS growth {r['rss_growth_mb']:.0f} MB")
    assert r["frames"] == longrun.N_FRAMES
    assert not r["not_finite"], f"t, lam or the map not finite at frames {r['not_finite']}"
    assert r["tracked"] >= longrun.TRACKED, f"tracked only {r['tracked']:.2f}"
    assert r["centres_finite"]
    lo, hi = longrun.PATH_RATIO
    assert lo < r["path_ratio"] < hi, f"path ratio {r['path_ratio']:.2f}"
    assert r["ate"] < longrun.ATE, f"long-run ATE {r['ate']:.3f} (drift)"
    assert not r["reshaped"], f"carried state changed shape at frames {r['reshaped']}"
    assert not r["rebuilt"], f"kernel library built or loaded at frames {r['rebuilt']}"
    assert r["rss_growth_mb"] < longrun.RSS_MB, f"RSS grew {r['rss_growth_mb']:.0f} MB"

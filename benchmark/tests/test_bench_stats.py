"""The metric arithmetic on made-up numbers."""

import numpy as np
import pytest

from benchmark.harness import stats, trace


def test_p95_is_over_all_frames():
    rng = np.random.default_rng(0)
    lat = list(rng.exponential(10.0, 997))
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    # one slow batch of 8 frames in 200 batches: every frame counts
    frames = [10.0] * (199 * 8) + [80.0] * 8
    assert stats.percentile(frames, 95) == 10.0
    assert stats.percentile(frames, 99.9) == 80.0


def test_union_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8), (9, 10)]
    assert stats.union(iv) == [(0, 3), (5, 6), (9, 10)]
    assert stats.covered(iv, 0, 10) == pytest.approx(5.0)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.covered(iv, 2, 5.5) == pytest.approx(1.5)


def test_idle_share_is_a_union_not_a_sum():
    # two streams' kernels overlap: summing them would read 120 % busy
    session = {"records": [("a", 0.0, 60.0, "kernel"), ("b", 0.0, 60.0, "kernel"),
                           ("Memcpy HtoD", 70.0, 80.0, "memcpy")],
               "window": (0.0, 100.0), "spans": [("fetch", 60.0, 100.0)]}
    assert trace.busy_us(session) == pytest.approx(70.0)
    assert trace.window_us(session) == pytest.approx(100.0)
    gaps = trace.idle_gaps(session)
    assert gaps == [["fetch", pytest.approx(30e-6)]]


def test_kernel_names_by_whole_word():
    table = {"blur_level_kernel": "K1", "mask_kernel": "K8"}
    recs = [("void blur_level_kernel<15>(float const*)", 0, 1, "kernel"),
            ("void blur_level_any_kernel(float const*)", 0, 1, "kernel"),
            ("small_octaves_kernel_masks", 0, 1, "kernel"),
            ("mask_kernel", 0, 1, "kernel"), ("Memcpy DtoH (Device -> Pinned)", 0, 1, "memcpy")]
    assert trace.classify(recs, table) == ["K1", None, None, "K8", None]

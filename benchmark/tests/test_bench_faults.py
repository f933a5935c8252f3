"""A run with the timed path broken underneath comes out not correct:
a VO step that returns its state unchanged, or its window not rolled, or
a pose or the map altered after its BA; half of a batch left out; and an
answer altered where it is produced.  The harness runs on the CPU
at a size a test run holds (no look for a card)."""

import pytest
import torch

import sift_pyocl_tpu_torch as port
from sift_pyocl_tpu_torch import models
from sift_pyocl_tpu_torch.parallel import video
from benchmark.harness import faults
from benchmark.tests._small import run_small


def _shift(buf, dx=1.0):
    return buf._replace(x=buf.x + dx)


def test_fault_vo_state_unchanged(monkeypatch):
    real = port.vo_step

    def stuck(state, frame, K, cfg, vo, **kw):
        _, out = real(state, frame, K, cfg, vo, **kw)
        return state, out

    monkeypatch.setattr(port, "vo_step", stuck)
    assert run_small("vo_1080p.pan")["correct"] is False


@pytest.mark.parametrize("name", sorted(faults.VO_FAULTS))
def test_fault_vo_window_altered(monkeypatch, name):
    real = port.vo_step
    fault = faults.VO_FAULTS[name]

    def altered(state, frame, K, cfg, vo, **kw):
        new, out = real(state, frame, K, cfg, vo, **kw)
        return fault(state, new, vo.window, float(K[0, 0])), out

    monkeypatch.setattr(port, "vo_step", altered)
    r = run_small("vo_1080p.pan")
    assert r["correct"] is False
    # caught by the window's numbers, not by the keypoints or the match count
    caught = [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]
    assert set(caught) & {"roll_gap", "ba_fit_px", "ba_rise"}, caught


def test_fault_vo_answer_altered(monkeypatch):
    real = port.vo_step

    def moved(state, frame, K, cfg, vo, **kw):
        new, out = real(state, frame, K, cfg, vo, **kw)
        return new._replace(prev_uv=new.prev_uv + 1.0), out

    monkeypatch.setattr(port, "vo_step", moved)
    assert run_small("vo_1080p.pan")["correct"] is False


def test_fault_half_the_batch_left_out(monkeypatch):
    real = video.VideoSiftFrontend.__call__

    def half(self, frames):
        buf = real(self, frames)
        keep = torch.arange(buf.valid.shape[0])[:, None] < buf.valid.shape[0] // 2
        return buf._replace(valid=buf.valid & keep)

    monkeypatch.setattr(video.VideoSiftFrontend, "__call__", half)
    assert run_small("sift_1080p.video_b8", seconds=2.0)["correct"] is False


def test_fault_video_answer_altered(monkeypatch):
    real = video.VideoSiftFrontend.__call__
    monkeypatch.setattr(video.VideoSiftFrontend, "__call__",
                        lambda self, frames: _shift(real(self, frames)))
    assert run_small("sift_1080p.video_b8")["correct"] is False


def test_fault_vo_match_count_altered(monkeypatch):
    real = port.vo_step

    def miscounted(state, frame, K, cfg, vo, **kw):
        new, out = real(state, frame, K, cfg, vo, **kw)
        return new, out._replace(n_matches=out.n_matches + out.n_matches // 4 + 2)

    monkeypatch.setattr(port, "vo_step", miscounted)
    assert run_small("vo_1080p.pan")["correct"] is False


def test_fault_single_answer_altered(monkeypatch):
    real = models.sift.SiftPlan.keypoints

    def moved(self, image):
        recs = real(self, image)
        recs["angle"] = recs["angle"] + 0.2
        return recs

    monkeypatch.setattr(models.sift.SiftPlan, "keypoints", moved)
    assert run_small("sift_1080p.single")["correct"] is False


@pytest.mark.parametrize("cell", ["vo_1080p.pan", "sift_1080p.video_b8", "sift_1080p.single"])
def test_sound_run_is_correct(cell):
    r = run_small(cell)
    assert r["correct"] is True and r["attempted"] > 0
    assert list(r)[-1] == "checks"

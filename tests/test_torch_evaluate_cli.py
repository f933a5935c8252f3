"""The port's evaluate CLI (sift_pyocl_tpu_torch/evaluate.py) against the
JAX package's (tests/test_evaluate_cli.py): the parsers, the quaternion and
the round trips compared with the JAX functions on the same input, and the
end-to-end CLI run with --device cpu (`slow`, as the original is)."""

import json

import numpy as np
import pytest
import torch

import sift_pyocl_tpu.evaluate as jev

from sift_pyocl_tpu_torch import evaluate as tev
from sift_pyocl_tpu_torch.evaluate import (load_gt_centers, main, probe_pgm_shape,
                                           quat_from_R, save_sequence, save_trajectory_tum)
from sift_pyocl_tpu_torch.sfm.evaluate import camera_centers
from sift_pyocl_tpu_torch.utils.render3d import render_sequence
from _torch_threads import _one_torch_thread  # noqa: F401


def _rotations(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.normal(size=3) * scale
        th = np.linalg.norm(a)
        k = a / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx)
    return np.stack(out), rng


def test_gt_parsers(tmp_path):
    p = tmp_path / "tum.txt"
    p.write_text("# comment\n0.0 1 2 3 0 0 0 1\n1.0 4 5 6 0 0 0 1\n")
    np.testing.assert_allclose(load_gt_centers(p), [[1, 2, 3], [4, 5, 6]])
    p2 = tmp_path / "kitti.txt"
    p2.write_text("1 0 0 9 0 1 0 8 0 0 1 7\n")
    np.testing.assert_allclose(load_gt_centers(p2), [[9, 8, 7]])
    p3 = tmp_path / "xyz.txt"
    p3.write_text("1 2 3\n")
    np.testing.assert_allclose(load_gt_centers(p3), [[1, 2, 3]])
    for q in (p, p2, p3):
        np.testing.assert_array_equal(load_gt_centers(q), jev.load_gt_centers(q))
    p4 = tmp_path / "bad.txt"
    p4.write_text("1 2\n")
    with pytest.raises(ValueError, match="unrecognized"):
        load_gt_centers(p4)


def test_save_and_probe_roundtrip(tmp_path):
    """Frames written as PGM and the TUM file, byte for byte the JAX
    package's; the shape probed back (also from a header with a comment)."""
    frames = [np.linspace(0, 255, 48 * 64, dtype=np.float32).reshape(48, 64),
              np.full((48, 64), 300.0, np.float32)]
    R = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    t = np.array([[0, 0, 0], [0.5, -1, 2]], np.float32)
    out, gt = save_sequence(tmp_path / "seq", frames, R, t)
    jout, jgt = jev.save_sequence(tmp_path / "jseq", frames, R, t)
    pgms = sorted(out.glob("*.pgm"))
    assert [p.name for p in pgms] == [p.name for p in sorted(jout.glob("*.pgm"))]
    for p in pgms:
        assert p.read_bytes() == (jout / p.name).read_bytes()
        assert probe_pgm_shape(p) == jev.probe_pgm_shape(p) == (48, 64)
    assert gt.read_text() == jgt.read_text()
    np.testing.assert_allclose(load_gt_centers(gt), camera_centers(R, t))
    c = tmp_path / "c.pgm"
    c.write_bytes(b"P5\n# made by hand\n7 5\n255\n" + bytes(35))
    assert probe_pgm_shape(c) == jev.probe_pgm_shape(c) == (5, 7)


def test_quat_from_R_roundtrip():
    """The quaternion rebuilds R (20 random rotations, and the trace <= 0
    branch), and equals the JAX package's."""
    Rs, _ = _rotations(20, 0)
    Rs = np.concatenate([Rs, np.diag([1.0, -1.0, -1.0])[None], np.diag([-1.0, 1.0, -1.0])[None]])
    for R in Rs:
        x, y, z, w = quat_from_R(R)
        R2 = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        np.testing.assert_allclose(R2, R, atol=1e-9)
        np.testing.assert_array_equal(quat_from_R(R), jev.quat_from_R(R))


def test_save_trajectory_tum_roundtrip(tmp_path):
    """--save-traj output parses as TUM gt with matching centers, and its
    text equals the JAX package's."""
    Rs, rng = _rotations(5, 1, scale=0.3)
    ts = rng.normal(size=(5, 3))
    p, jp = tmp_path / "traj.txt", tmp_path / "jtraj.txt"
    save_trajectory_tum(p, Rs, ts, stamps=[0, 2, 3, 5, 9])
    jev.save_trajectory_tum(jp, Rs, ts, stamps=[0, 2, 3, 5, 9])
    assert p.read_text() == jp.read_text()
    np.testing.assert_allclose(load_gt_centers(p), camera_centers(Rs, ts), atol=1e-6)


def test_cli_refuses_what_the_original_refuses(tmp_path, capsys):
    """No frames, raw .f32 without --shape, and too short a gt file each
    print one JSON error line and return 1; without a card, the default
    device raises."""
    (tmp_path / "empty").mkdir()
    gt = tmp_path / "gt.txt"
    gt.write_text("0 0 0\n")
    assert main(["--frames", str(tmp_path / "empty"), "--gt", str(gt), "--device", "cpu"]) == 1
    assert "no frames" in json.loads(capsys.readouterr().out)["error"]
    (tmp_path / "raw").mkdir()
    np.zeros((4, 4), np.float32).tofile(tmp_path / "raw" / "a.f32")
    assert main(["--frames", str(tmp_path / "raw"), "--gt", str(gt), "--device", "cpu"]) == 1
    assert "--shape" in json.loads(capsys.readouterr().out)["error"]
    assert tev.main.__module__ == "sift_pyocl_tpu_torch.evaluate"


def test_cli_default_device_is_the_card(tmp_path, monkeypatch):
    """Without --device the CLI runs on the CUDA card, and raises where
    there is none (no silent CPU run)."""
    K, frames, gtR, gtT = render_sequence(n_frames=3, n_points=40, image_size=(96, 80),
                                          seed=0, arc_deg=10.0)
    seq, gt = save_sequence(tmp_path / "seq", frames, gtR, gtT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("sfm", "vo"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--frames", str(seq), "--gt", str(gt), "--mode", mode])


@pytest.mark.slow
def test_evaluate_cli_sfm_ate(tmp_path, capsys):
    """tests/test_evaluate_cli.py::test_evaluate_cli_sfm_ate through the
    port on the CPU: the same keys, >= 6 of 7 registered, ATE < 0.15."""
    K, frames, gtR, gtT = render_sequence(
        n_frames=7, n_points=70, image_size=(320, 240), seed=0, arc_deg=25.0
    )
    seq_dir, gt_path = save_sequence(tmp_path / "seq", frames, gtR, gtT)
    traj = tmp_path / "est.txt"
    rc = main([
        "--frames", str(seq_dir), "--gt", str(gt_path),
        "--mode", "sfm", "--fx", str(float(K[0, 0])), "--device", "cpu",
        "--save-traj", str(traj),
    ])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rep = json.loads(out)
    assert rc == 0, rep
    assert set(rep) == {"ate_rmse", "n_frames", "n_registered", "mode", "shape"}
    assert rep["n_registered"] >= 6
    # PGM u8 quantization costs some accuracy vs the float test (0.08 bound)
    assert rep["ate_rmse"] < 0.15, rep
    assert len(load_gt_centers(traj)) == rep["n_registered"]

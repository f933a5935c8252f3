"""The port's fixture loader (utils/fixtures.py) against the JAX package's
(tests/test_fixtures.py): the same directories and variable, and the same
fixture loaded to the same array by both."""

import numpy as np
import pytest

from sift_pyocl_tpu.utils import fixtures as jfix

from sift_pyocl_tpu_torch.utils import fixtures as tfix


def test_fixture_roundtrip(tmp_path, monkeypatch):
    """tests/test_fixtures.py's round trip (PGM, .npy, a missing name),
    plus an RGB .npy and a raw .f32 with its .shape file, each equal to
    the JAX package's load bit for bit."""
    img = np.linspace(0, 255, 32 * 48, dtype=np.float32).reshape(32, 48)
    u8 = img.astype(np.uint8)
    (tmp_path / "demo.pgm").write_bytes(b"P5\n48 32\n255\n" + u8.tobytes())
    np.save(tmp_path / "demo2.npy", img)
    rgb = np.random.default_rng(0).integers(0, 255, (20, 24, 4)).astype(np.uint8)
    np.save(tmp_path / "rgb.npy", rgb)
    img.tofile(tmp_path / "raw.f32")
    (tmp_path / "raw.shape").write_text("32 48\n")
    monkeypatch.setenv("SIFT_PYOCL_FIXTURES", str(tmp_path))
    assert tfix.fixture_dirs()[0] == jfix.fixture_dirs()[0] == tmp_path
    np.testing.assert_allclose(tfix.reference_test_image("demo"), u8.astype(np.float32))
    np.testing.assert_allclose(tfix.reference_test_image("demo2"), img)
    for name in ("demo", "demo2", "rgb", "raw"):
        got, want = tfix.reference_test_image(name), jfix.reference_test_image(name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert tfix.reference_test_image("missing") is None


def test_default_dirs_are_the_jax_packages():
    """One fixtures folder serves both packages."""
    assert tfix.DEFAULT_DIRS == jfix.DEFAULT_DIRS


def test_unsupported_fixture_format_raises(tmp_path):
    (tmp_path / "x.txt").write_text("1 2")
    with pytest.raises(ValueError, match="unsupported"):
        tfix._load(tmp_path / "x.txt")

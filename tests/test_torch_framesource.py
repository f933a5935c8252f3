"""The port's frame source (utils/framesource.py, native/) against the JAX
package's: tests/test_framesource.py's formats, the native loader built
with g++ here, its decode equal to NumPy's bit for bit, and no fallback
when the loader cannot be built."""

import numpy as np
import pytest

from sift_pyocl_tpu.utils.framesource import FrameSource as JFrameSource
from sift_pyocl_tpu.utils.framesource import _decode_numpy as j_decode

from sift_pyocl_tpu_torch import native
from sift_pyocl_tpu_torch.utils.framesource import FrameSource, _decode_numpy

from test_framesource import _write_pgm, _write_ppm


@pytest.fixture()
def frames_dir(tmp_path):
    """tests/test_framesource.py's four frames: PGM 8- and 16-bit (with a
    comment line), PPM and raw .f32."""
    rng = np.random.default_rng(0)
    h, w = 24, 32
    paths, want = [], []
    g8 = rng.integers(0, 255, (h, w))
    _write_pgm(tmp_path / "a.pgm", g8)
    want.append(g8.astype(np.float32))
    g16 = rng.integers(0, 65535, (h, w))
    _write_pgm(tmp_path / "b.pgm", g16, maxval=65535)
    want.append(g16.astype(np.float32))
    rgb = rng.integers(0, 255, (h, w, 3))
    _write_ppm(tmp_path / "c.ppm", rgb)
    want.append(rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))
    raw = rng.uniform(0, 255, (h, w)).astype(np.float32)
    raw.tofile(tmp_path / "d.f32")
    want.append(raw)
    paths = [tmp_path / n for n in ("a.pgm", "b.pgm", "c.ppm", "d.f32")]
    return paths, want, (h, w)


@pytest.mark.parametrize("native_", [False, True])
def test_framesource_decodes_all_formats(frames_dir, native_):
    paths, want, shape = frames_dir
    fs = FrameSource(paths, shape, native=native_)
    assert fs.backend == ("native" if native_ else "numpy")
    got = list(fs)
    assert [i for i, _ in got] == list(range(len(paths)))
    for (_, g), w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == shape
        np.testing.assert_allclose(g, w, atol=5e-3)


def test_native_and_numpy_decodes_are_equal_and_match_jax(frames_dir):
    """Native and NumPy frames equal bit for bit, and equal to the JAX
    package's NumPy decode (its FrameSource with native=False) bit for bit
    on gray and raw frames, within 2 f32 ulps on the RGB frame (its weights
    summed in the loader's order, not by a matmul)."""
    paths, _, shape = frames_dir
    nat = [f for _, f in FrameSource(paths, shape, native=True)]
    ref = [f for _, f in FrameSource(paths, shape, native=False)]
    jref = [f for _, f in JFrameSource(paths, shape, native=False)]
    for a, b, c, p in zip(nat, ref, jref, paths):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, _decode_numpy(p, shape))
        np.testing.assert_array_equal(c, j_decode(p, shape))
        if p.suffix == ".ppm":
            np.testing.assert_array_max_ulp(b, c, maxulp=2)
        else:
            np.testing.assert_array_equal(b, c)


def test_native_loader_build_failure_raises(frames_dir, tmp_path, monkeypatch):
    """A compiler that cannot run makes FrameSource(native=True) raise; it
    does not fall back to NumPy.  native=False still reads."""
    paths, want, shape = frames_dir
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native frame loader"):
        FrameSource(paths, shape, native=True)
    assert not list((tmp_path / "build").glob("*.so"))
    fs = FrameSource(paths, shape, native=False)
    assert fs.backend == "numpy" and len(list(fs)) == len(paths)


def test_native_loader_is_cached_by_source_hash(tmp_path):
    """The loader is built once into its build directory under a name keyed
    by the source and compiler, and loads with its entry points typed."""
    lib = native.load(tmp_path)
    so = native.library_path(tmp_path)
    assert so.is_file() and so.parent == tmp_path and so.name.startswith("framesource_")
    assert native.library_path(tmp_path, "clang++") != so
    mtime = so.stat().st_mtime_ns
    native.load(tmp_path)
    assert so.stat().st_mtime_ns == mtime
    assert lib.fs_next.restype is not None


def test_decode_errors(tmp_path):
    """A wrong shape and an unknown header raise, as in the original."""
    _write_pgm(tmp_path / "a.pgm", np.zeros((8, 10)))
    with pytest.raises(ValueError, match="expected"):
        _decode_numpy(tmp_path / "a.pgm", (10, 8))
    (tmp_path / "b.pgm").write_bytes(b"P2\n2 2\n255\n0 0 0 0\n")
    with pytest.raises(ValueError, match="unsupported"):
        _decode_numpy(tmp_path / "b.pgm", (2, 2))


def test_png_frames_via_pil(tmp_path):
    """PNG frames go through PIL, as in the original (backend "numpy" even
    with native=True, chosen by format)."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (32, 40)).astype("uint8") for _ in range(3)]
    paths = []
    for i, im in enumerate(imgs):
        p = tmp_path / f"f{i:03d}.png"
        PIL.fromarray(im, mode="L").save(p)
        paths.append(p)
    fs = FrameSource(paths, (32, 40))
    assert fs.backend == "numpy"
    out = list(fs)
    assert len(out) == 3
    for (idx, frame), im in zip(out, imgs):
        np.testing.assert_array_equal(frame, im.astype(np.float32))

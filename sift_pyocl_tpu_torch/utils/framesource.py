"""Streaming frame source: NumPy float32 grayscale frames from files.

Port of ``sift_pyocl_tpu/utils/framesource.py``.  The native loader
(``native/framesource.cpp``) decodes the next frame on a C++ thread while
the caller works on the current one; ``_decode_numpy`` is the same decode
in NumPy, equal to it bit for bit (its RGB weights summed in the loader's
order; the JAX package's matmul is ~1 ulp away).  Formats: binary PGM/PPM
(8- and 16-bit), raw ``.f32`` of a given shape, and PNG/JPEG/TIFF/BMP
through PIL.  Frames stay on the host: copying them to the card is the
caller's job.

Unlike the JAX package's, ``FrameSource(native=True)`` never falls back to
NumPy: it raises when the loader cannot be built or loaded.  NumPy runs
when the caller asks for it (``native=False``) or for the PIL formats,
where the original also chooses by format; ``backend`` says which one runs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

PIL_SUFFIXES = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def _decode_numpy(path: Path, shape: Tuple[int, int]) -> np.ndarray:
    H, W = shape
    if path.suffix == ".f32":
        return np.fromfile(path, dtype=np.float32, count=H * W).reshape(H, W)
    if path.suffix.lower() in PIL_SUFFIXES:
        # real benchmark sequences (TUM/KITTI) ship PNGs; PIL is optional
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
        if img.shape != (H, W):
            raise ValueError(f"{path}: {img.shape} != expected {(H, W)}")
        return img
    data = path.read_bytes()
    if not data.startswith((b"P5", b"P6")):
        raise ValueError(f"unsupported format: {path}")
    # parse 3 header ints, skipping comments
    vals: List[int] = []
    i = 2
    while len(vals) < 3:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while not data[j : j + 1].isspace():
            j += 1
        vals.append(int(data[i:j]))
        i = j
    i += 1  # single whitespace after maxval
    w, h, maxval = vals
    if (h, w) != (H, W):
        raise ValueError(f"{path}: {h}x{w} != expected {H}x{W}")
    ch = 3 if data.startswith(b"P6") else 1
    if maxval < 256:
        px = np.frombuffer(data, np.uint8, h * w * ch, i).astype(np.float32)
    else:
        px = (
            np.frombuffer(data, ">u2", h * w * ch, i).astype(np.float32)
        )
    if ch == 3:
        # the native loader's sum, term by term in f32 (a matmul, as in the
        # JAX package, rounds in another order: ~1 ulp apart)
        rgb = px.reshape(h, w, 3)
        c = np.array([0.299, 0.587, 0.114], np.float32)
        px = c[0] * rgb[..., 0] + c[1] * rgb[..., 1] + c[2] * rgb[..., 2]
    return px.reshape(h, w)


class FrameSource:
    """Iterate (index, float32 grayscale frame) from PGM/PPM/.f32 files
    (and PIL formats), in order.

    >>> for idx, frame in FrameSource(paths, (480, 640)):
    ...     plan.keypoints(frame)
    """

    def __init__(self, paths: Sequence[Union[str, Path]],
                 shape: Tuple[int, int], native: bool = True):
        from .. import native as _native

        self.paths = [str(p) for p in paths]
        self.shape = tuple(shape)
        # the C++ loader decodes PGM/PPM/.f32; PNG/JPEG goes through PIL
        if any(Path(p).suffix.lower() in PIL_SUFFIXES for p in self.paths):
            native = False
        self._lib = _native.get_lib() if native else None
        self.backend = "native" if native else "numpy"

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        H, W = self.shape
        if self._lib is None:
            for i, p in enumerate(self.paths):
                yield i, _decode_numpy(Path(p), self.shape)
            return
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        handle = self._lib.fs_open(arr, len(self.paths), H, W)
        try:
            out = np.empty((H, W), np.float32)
            while True:
                idx = self._lib.fs_next(
                    handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                )
                if idx == -1:
                    return
                if idx == -2:
                    raise IOError("frame decode failed")
                yield int(idx), out.copy()
        finally:
            self._lib.fs_close(handle)

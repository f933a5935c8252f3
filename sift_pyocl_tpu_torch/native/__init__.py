"""The native frame loader (``framesource.cpp``), built with g++ at first
use and loaded with ctypes.

``framesource.cpp`` is the JAX package's loader byte for byte
(``tests/test_torch_config.py`` holds it so): PGM/PPM (8- and 16-bit) and
raw ``.f32`` frames decoded on a C++ thread, one frame ahead of the caller.
The library is built into ``_build/`` beside this package (listed in
``.gitignore``), named by a hash of the source, the compiler and its flags,
and written there under a temporary name first, so processes building at
once never load a partial file.  A failed build raises: nothing here falls
back to another decoder (``utils/framesource.py`` takes NumPy only when its
caller asks for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "framesource.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(build_dir: Path = BUILD_DIR, compiler: str = CXX) -> Path:
    """Where the loader built from the current source by `compiler` lives."""
    h = hashlib.sha256(" ".join((compiler,) + CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return Path(build_dir) / f"framesource_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR, compiler: str = CXX) -> Path:
    """Compile framesource.cpp unless its library exists; raises
    RuntimeError when the compiler is missing or fails."""
    out = library_path(build_dir, compiler)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [compiler, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except OSError as e:
        raise RuntimeError(f"native frame loader: cannot run {compiler!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native frame loader: {' '.join(cmd)} failed:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def load(build_dir: Path = BUILD_DIR, compiler: str = CXX) -> ctypes.CDLL:
    """Build if needed, load, and type the C entry points (fs_open,
    fs_next, fs_close)."""
    lib = ctypes.CDLL(str(build(build_dir, compiler)))
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                            ctypes.c_int, ctypes.c_int]
    lib.fs_next.restype = ctypes.c_long
    lib.fs_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.fs_close.restype = None
    lib.fs_close.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loader of this process (``load`` with ``BUILD_DIR`` and ``CXX``),
    loaded once; raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(BUILD_DIR, CXX)
        return _lib

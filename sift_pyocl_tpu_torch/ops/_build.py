"""Builds the CUDA kernels of ``csrc/`` and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds).  The library is built at first use into ``_build/`` beside this
package (listed in ``.gitignore``) and named by a hash of the sources and
flags, so a changed source is rebuilt and an unchanged one is loaded as it
is.  Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# --fmad=false: no contraction of a*b+c into one rounding, so each kernel
# rounds like its plain PyTorch version (one rounding per op).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# Entries (octaves, over every frame of a batch) that one launch of a
# multi-octave kernel (K3, K4, K5, K8) takes: csrc/common.cuh's SIFT_MAX_OCT.
MAX_ENTRIES = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[Tuple[str, tuple], ctypes._CFuncPtr] = {}
_events = {"builds": 0, "loads": 0}


def build_counts() -> Dict[str, int]:
    """How many times this process compiled the library (``build`` running
    nvcc) and loaded it (``library``): a long run asserts that neither
    grows after its first steps."""
    return dict(_events)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "sift_pyocl_tpu_torch/csrc need the CUDA toolkit to build")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsift_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    ``nvcc -c`` per source, run in parallel, then one link.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``_build/build.log``."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _events["builds"] += 1
    cu, _ = _sources()
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    tmp = out.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stdout + proc.stderr)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
    os.replace(tmp, out)
    return out


def entry_chunks(n: int, limit: int = MAX_ENTRIES) -> List[Tuple[int, int]]:
    """The launches of a multi-octave kernel over `n` entries: [start, stop)
    ranges of at most `limit` entries, in order, covering 0..n.  Each
    entry's output region is its own, so the launches give the bits one
    launch over all entries would."""
    if n < 1 or limit < 1:
        raise ValueError(f"need n >= 1 entries and limit >= 1, got {n}, {limit}")
    return [(a, min(a + limit, n)) for a in range(0, n, limit)]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _events["loads"] += 1
            lib.sift_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sift_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point `name` with its argument types set (c_void_p for every
    pointer and the stream, c_int / c_float for scalars); returns int.
    Looked up and typed once per (name, argtypes)."""
    key = (name, tuple(argtypes))
    fn = _fns.get(key)
    if fn is None:
        fn = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)((name, library()))
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = library().sift_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the device of `t`, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def as_bytes(valid: torch.Tensor) -> torch.Tensor:
    """A valid mask as the uint8 the kernels read: a view of a bool mask
    (no launch), a cast of any other type."""
    v = valid.contiguous()
    return v.view(torch.uint8) if v.dtype == torch.bool else v.to(torch.uint8)

"""The harness's spans and the device trace of a traced run.

``Spans`` times the harness's own spans on the host clock (``api``: each
call into the port; ``copy``: enqueueing the copy home; ``fetch``: waiting
for a result) outside the profiling sessions, whose own host overhead
they would count, and, while a session is open, marks them in the trace
as ``bench.<name>`` ranges, so that an idle gap of the device can be
named by what the host was doing.  A session opens with a preroll of spin
kernels (a frozen copy of the port's ``utils/profiling.py::open_session``:
torch.profiler drops a session's first records), and of several sessions
the one with the most device records is kept.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from . import stats

PREROLL = 64
PREROLL_KERNEL = "spin_kernel"
WINDOW_SPAN = "bench.traced"


class Spans:
    """Host seconds by span name, and the trace marks while profiling."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.profiling = False
        self.counting = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = torch.profiler.record_function(f"bench.{name}") if self.profiling else None
        if mark is not None:
            mark.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            if self.counting and not self.profiling:
                self.seconds[name] += time.perf_counter() - t
            if mark is not None:
                mark.__exit__(None, None, None)


def open_session() -> None:
    for _ in range(PREROLL):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def kind_of(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def read_session(prof) -> dict:
    """Device records ([name, start_us, end_us, kind]) inside the traced
    window, the harness spans, and the window (start_us, end_us)."""
    device, spans, window = [], [], None
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the device side of a record_function range is no device work
            if PREROLL_KERNEL not in e.name and not e.name.startswith("bench."):
                device.append((e.name, e.time_range.start, e.time_range.end, kind_of(e.name)))
        elif e.name == WINDOW_SPAN:
            window = (e.time_range.start, e.time_range.end)
        elif e.name.startswith("bench."):
            spans.append((e.name[len("bench."):], e.time_range.start, e.time_range.end))
    if window is None:
        raise RuntimeError("the traced window's span is missing from the trace")
    inside = [r for r in device if r[2] > window[0] and r[1] < window[1]]
    return {"records": inside, "spans": spans, "window": window}


def classify(records, table: Dict[str, str]) -> List[Optional[str]]:
    """The kernel id of each record's name by the kernel-name table (a
    whole-word match), or None for a library kernel, a copy or a set."""
    pats = [(re.compile(rf"\b{re.escape(name)}\b"), kid) for name, kid in table.items()]
    cache: Dict[str, Optional[str]] = {}
    out = []
    for name, _, _, kind in records:
        if name not in cache:
            cache[name] = None if kind != "kernel" else next(
                (kid for pat, kid in pats if pat.search(name)), None)
        out.append(cache[name])
    return out


def idle_gaps(session: dict, top: int = 10) -> List[List]:
    """Device idle seconds inside the window, summed by the harness span
    open on the host at each gap's middle (the innermost)."""
    w0, w1 = session["window"]
    by_span: Dict[str, float] = defaultdict(float)
    spans = sorted(session["spans"], key=lambda s: s[1])
    for a, b in stats.gaps([(r[1], r[2]) for r in session["records"]], w0, w1):
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[1] <= mid < s[2]]
        name = max(open_, key=lambda s: s[1])[0] if open_ else "no_span"
        by_span[name] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(session: dict, ids: List[Optional[str]], top: int = 10) -> List[List]:
    """Device seconds by kernel id, or by the library kernel's name."""
    by: Dict[str, float] = defaultdict(float)
    for (name, a, b, _), kid in zip(session["records"], ids):
        by[kid or name[:160]] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def busy_us(session: dict) -> float:
    w0, w1 = session["window"]
    return stats.covered([(r[1], r[2]) for r in session["records"]], w0, w1)


def window_us(session: dict) -> float:
    return session["window"][1] - session["window"][0]



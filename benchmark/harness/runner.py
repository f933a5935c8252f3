"""One run of one cell: set-up, the measured window, the traced
sub-windows, and the check against the reference."""

from __future__ import annotations

import sys
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from . import compare, entries, manifest, peaks, stats, trace
from .entries import _Unit


class Loop:
    """Units handed to the program in order, at most `in_flight` of them
    awaiting their results."""

    def __init__(self, entry, spans, in_flight: int):
        self.entry, self.spans, self.in_flight = entry, spans, max(1, in_flight)
        self.pending = deque()
        self.done: List[_Unit] = []
        self.index = 0

    def step(self, keep: bool = False, trace_keep: bool = False) -> _Unit:
        unit = _Unit(self.index)
        self.index += 1
        unit.t_in = time.perf_counter()
        self.entry.submit(unit, keep, trace_keep)
        self.pending.append(unit)
        while len(self.pending) >= self.in_flight:
            self._finish(self.pending.popleft())
        return unit

    def _finish(self, unit: _Unit) -> None:
        with self.spans("fetch"):
            self.entry.fetch(unit)
        unit.t_done = time.perf_counter()
        self.done.append(unit)

    def drain(self) -> None:
        while self.pending:
            self._finish(self.pending.popleft())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def traced_units(loop: Loop, entry, spans, units: int) -> dict:
    """One profiling session over `units` units: the session's reading and
    the units' facts."""
    loop.drain()
    _sync(entry.device)
    with trace.profiler() as prof:
        trace.open_session()
        spans.profiling = True
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            traced = [loop.step(keep=True, trace_keep=True) for _ in range(units)]
            loop.drain()
            _sync(entry.device)
        spans.profiling = False
    session = trace.read_session(prof)
    session["facts"] = [f for u in traced for f in entry.facts(u)]
    session["frames"] = units * entry.frames_per_unit
    session["units"] = traced
    return session


def kernel_bounds(session: dict, ids: List[Optional[str]]) -> Dict[str, float]:
    """Bound ms of every hand-written kernel of the session that has a
    bound file, summed over the traced frames' calls."""
    out = {}
    for kid in sorted({k for k in ids if k}):
        mod = manifest.kernel_bound(kid)
        if mod is None:
            print(f"[bench] kernel {kid} has no bound file: its time counts in the "
                  "roofline share's denominator only", file=sys.stderr)
            continue
        out[kid] = sum(peaks.bound_ms(*call) for f in session["facts"] for call in mod.calls(f))
    return out


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        shape=None, after=None) -> dict:
    """The result line's fields.  ``after(entry, numbers)``, where given, is
    called once the check has run (the calibration reads the control
    there)."""
    tr = cell.traffic
    spans = trace.Spans()
    marks = [("imports", time.perf_counter())]
    entry = entries.make(cell, seed, device, shape)
    entry.spans = spans
    loop = Loop(entry, spans, int(tr.get("in_flight", 1)))
    marks.append(("inputs and program", time.perf_counter()))
    entry.start()
    marks.append(("start", time.perf_counter()))
    for _ in range(int(tr["warm_units"])):
        loop.step()
    loop.drain()
    _sync(device)
    marks.append(("warm units", time.perf_counter()))
    starts = [t0] + [t for _, t in marks]
    print("[bench] set-up s: " + ", ".join(f"{name} {t - t_prev:.3f}"
                                           for (name, t), t_prev in zip(marks, starts)),
          file=sys.stderr)
    captures0 = entry.captures()
    loop.done.clear()

    spans.counting = True
    t_start = time.perf_counter()
    setup_s = t_start - t0
    t_end = t_start + seconds
    sessions = []
    n_sessions = int(tr["trace_sessions"]) if traced else 0
    gap = int(tr["trace_gap_units"])
    since = 0
    while time.perf_counter() < t_end or len(sessions) < n_sessions:
        if len(sessions) < n_sessions and since >= gap:
            sessions.append(traced_units(loop, entry, spans, int(tr["trace_units"])))
            since = 0
            continue
        loop.step(keep=True)
        since += 1
    loop.drain()
    spans.counting = False
    _sync(device)
    units = loop.done
    fpu = entry.frames_per_unit
    frames_in_window = fpu * sum(1 for u in units if u.t_done <= t_end)
    latencies = [1e3 * (u.t_done - u.t_in) for u in units for _ in range(fpu)]
    captures = entry.captures() - captures0
    dev = torch.device(device)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result = {"attempted": fpu * len(units), "failed": 0}
    metrics = {}
    if not traced:
        values = {"frames_per_s": frames_in_window / seconds,
                  "frame_p95_ms": stats.percentile(latencies, 95),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[manifest.base_name(m["name"], values)],
                                  "unit": m["unit"]}
        print(f"[bench] {cell.name} seed {seed}: {len(units)} units, {frames_in_window} frames "
              f"in {seconds} s; latency median {stats.percentile(latencies, 50):.4f} ms, "
              f"p95 {values['frame_p95_ms']:.4f} ms",
              file=sys.stderr)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if traced:
        best = max(sessions, key=lambda s: len(s["records"]) / s["frames"])
        table = manifest.kernel_table()
        ids = trace.classify(best["records"], table)
        ctx = {"session": best, "ids": ids, "frames": best["frames"],
               "bound_ms": kernel_bounds(best, ids),
               "api_host_s": spans.seconds["api"],
               "frames_done": fpu * (len(units) - sum(len(s["units"]) for s in sessions)),
               "captures": captures}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = trace.busy_us(best) * 1e-6
        device_info["window_s"] = trace.window_us(best) * 1e-6
        result["breakdown"] = {"device_ops": trace.device_ops(best, ids),
                               "idle_gaps": trace.idle_gaps(best)}
        print(f"[bench] traced sessions: records {[len(s['records']) for s in sessions]}, "
              f"kept {len(best['records'])} over {best['frames']} frames", file=sys.stderr)

    # the check, once the window has closed and the program's graphs are freed
    for cache in entry.caches():
        cache.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check()
    print(f"[bench] compared with the reference: {numbers}", file=sys.stderr)
    if after is not None:
        after(entry, numbers)
    limits = cell.limits["limits"]
    verdict = compare.judge(numbers, limits)
    result["correct"] = verdict is None
    if captures:
        print(f"[bench] {captures} graph captures inside the window", file=sys.stderr)
    if verdict:
        print(f"[bench] not correct: {verdict}", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result

"""The benchmark's manifest (``BENCHMARK.json`` at the root of a checkout)
and the data files it names: a configuration is
``benchmark/configs/<config>.json``, a traffic mix
``benchmark/traffic/<traffic>.json``, a cell's correctness limits
``benchmark/limits/<cell>.json``, a per-layer metric's reader
``benchmark/metrics/<metric>.py`` (or that of the metric it was split
from) and a hand-written kernel's bound
``benchmark/bounds/<kernel id>.py``.  Each is found by its name alone, so
a cell, a configuration, a metric or a bound is added by adding files and
manifest entries."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: dict, name: str, bench_dir: Path = BENCH_DIR):
        self.workload = by_name(manifest["workloads"], name, "workload")
        self.name = name
        self.config = _json(bench_dir / "configs" / f"{self.workload['config']}.json")
        self.traffic = _json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(bench_dir / "limits" / f"{name}.json")
        self.end_to_end = [m for m in manifest["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._has(m)]
        self.chips = int(self.workload["chips"])

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def base_name(name: str, known) -> str:
    """A metric split by the cells that report it is ``<name>.<group>``
    (``frames_per_s.sift``): the name itself where `known` has it, else
    the name without its last ``.<group>``."""
    while name not in known and "." in name:
        name = name.rsplit(".", 1)[0]
    return name


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """A per-layer metric's reader, ``metrics/<name>.py``, or that of the
    metric it was split from (``base_name``)."""
    known = {p.stem for p in (bench_dir / "metrics").glob("*.py")}
    name = base_name(name, known)
    return load_module(bench_dir / "metrics" / f"{name}.py", f"bench_metric_{name}")


def kernel_bound(kid: str, bench_dir: Path = BENCH_DIR) -> Optional[ModuleType]:
    """The bound file of a hand-written kernel, or None where it has none."""
    path = bench_dir / "bounds" / f"{kid}.py"
    return load_module(path, f"bench_bound_{kid}") if path.is_file() else None


def kernel_table(bench_dir: Path = BENCH_DIR) -> Dict[str, str]:
    """Device kernel name -> kernel id (K1 ... K13) of the hand-written
    kernels (``kernels.json``)."""
    return {k: v["id"] for k, v in _json(bench_dir / "kernels.json").items()}

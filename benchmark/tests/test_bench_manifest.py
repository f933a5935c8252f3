"""The manifest against the contract's rules of form, and every file it
names found by name."""

import json
import re

import pytest

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
PER_LAYER = [m["name"] for m in M["per_layer"]]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and M["run_seconds"] == int(M["run_seconds"])
    assert M["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])


def test_names_units_and_text_fields():
    names = ([c["name"] for c in M["configs"]] + CELLS
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in M["configs"] + M["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in M["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert {"frames_per_s", "frame_p95_ms", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cells_found_by_name(cell):
    c = manifest.Cell(M, cell)
    assert c.chips == 1
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["entry"] in ("vo_stream", "video_frontend", "sift_plan")
    assert c.limits["limits"]
    names = {manifest.base_name(m["name"], {"frames_per_s", "setup_s"}) for m in c.end_to_end}
    assert {"frames_per_s", "setup_s"} <= names and len(names) >= 2
    per_layer = {m["name"] for m in c.per_layer}
    assert per_layer and all(m["moves"] in {e["name"] for e in c.end_to_end}
                             for m in c.per_layer)


@pytest.mark.parametrize("metric", PER_LAYER)
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(manifest.metric_reader(metric).read)


def test_a_split_metric_takes_its_base_name():
    known = {"frames_per_s", "api.host_ms_per_frame"}
    assert manifest.base_name("frames_per_s.sift", known) == "frames_per_s"
    assert manifest.base_name("api.host_ms_per_frame.sift", known) == "api.host_ms_per_frame"
    assert manifest.base_name("api.host_ms_per_frame", known) == "api.host_ms_per_frame"


def test_configs_keep_the_port_defaults():
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig

    for c in M["configs"]:
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert SiftConfig(**data["sift"]) == SiftConfig()
        if "vo" in data:
            assert VOConfig(**data["vo"]) == VOConfig()
        assert len(c["source"]) <= 200

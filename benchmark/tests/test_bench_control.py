"""The control: the reference in bfloat16 put in the program's place
comes out not correct under every cell's limits (here at a size a test
run holds; on the card at the cells' own, benchmark/calibrate.py)."""

import pytest

from benchmark.harness import compare, manifest
from benchmark.tests._small import run_small

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    seen = {}

    def after(entry, numbers):
        seen["program"] = numbers
        seen["control"] = entry.check(control=True)

    run_small(cell, after=after)
    limits = manifest.Cell(manifest.load_manifest(), cell).limits["limits"]
    assert seen["program"]["ref_keypoints"] >= 5
    assert compare.judge(seen["program"], limits) is None
    assert compare.judge(seen["control"], limits) is not None

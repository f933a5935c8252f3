"""Every cell through the command the driver runs, on a CUDA card (the
rest of this folder's tests run on the CPU).  Run on the card:

    python -m pytest -m gpu benchmark/tests/test_bench_gpu.py -q
"""

import json
import subprocess
import sys

import pytest

from benchmark.harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, traced):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", str(2 ** 32 + 5), "--seconds", "3", "--trace", str(traced)],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"

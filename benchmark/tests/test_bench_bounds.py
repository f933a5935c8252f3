"""The frozen bound files against the kernel table of PERF.md at
1080x1920, for the kernels whose counts depend only on shapes (by
bytes), and the kernel-name table against the CUDA sources."""

import re

import pytest

from benchmark.harness import manifest, peaks

TABLE_MS = {"K1": 0.0297, "K2": 0.0097, "K5": 0.0394, "K3": 0.0024, "K8": 0.0189}


def _facts():
    from sift_pyocl_tpu_torch import SiftConfig
    return {"shape": (1080, 1920), "cfg": SiftConfig(), "caps": [2048, 1024, 512, 256, 128, 128, 128],
            "kp_octave": [0] * 1500, "kp_sigma": None, "n_slots_ok": 3000,
            "k7": [(8448, 2500, 2048, 2048), (256, 256, 8448, 2500)]}


@pytest.mark.parametrize("kid", sorted(TABLE_MS))
def test_shape_only_bounds_match_the_kernel_table(kid):
    (n_bytes, ops, peak), = manifest.kernel_bound(kid).calls(_facts())
    assert n_bytes / peaks.HBM_BPS >= ops / peak            # bound by bytes
    assert peaks.bound_ms(n_bytes, ops, peak) == pytest.approx(TABLE_MS[kid], abs=5e-5)


@pytest.mark.parametrize("kid", ["K4", "K6", "K7"])
def test_count_bounds_grow_with_the_work(kid):
    f = _facts()
    small = sum(peaks.bound_ms(*c) for c in manifest.kernel_bound(kid).calls(f))
    f.update(kp_octave=[0] * 3000, k7=[(8448, 5000, 2048, 2048), (256, 256, 8448, 5000)])
    big = sum(peaks.bound_ms(*c) for c in manifest.kernel_bound(kid).calls(f))
    assert 0 < small < big


def test_every_global_kernel_is_in_the_name_table():
    table = manifest.kernel_table()
    csrc = manifest.ROOT / "sift_pyocl_tpu_torch" / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")
    names = {m.group(1) for p in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))
             for m in pat.finditer(p.read_text())}
    assert len(names) >= 15
    assert names <= set(table), sorted(names - set(table))
    assert set(table.values()) >= {f"K{i}" for i in range(1, 9)}

"""The import guard, and that the harness and the reference load neither
JAX nor the JAX package (and the reference nothing of the port)."""

import subprocess
import sys

from benchmark.harness import guard, manifest


def test_whole_top_level_names():
    assert guard.forbidden_loaded(["sift_pyocl_tpu_torch", "sift_pyocl_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["sift_pyocl_tpu.ops.detect", "jax._src", "flax",
                                   "jaxlib.xla_client"]) == ["flax", "jax", "jaxlib",
                                                             "sift_pyocl_tpu"]


def _loaded_after(imports: str) -> set:
    code = (f"import sys; {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(out.split())


def test_harness_and_metric_readers_load_no_jax():
    mods = _loaded_after("import benchmark.harness.runner, benchmark.harness.entries, "
                         "benchmark.reference.vo; from benchmark.harness import manifest; "
                         "[manifest.metric_reader(m['name']) for m in "
                         "manifest.load_manifest()['per_layer']]")
    assert not mods & guard.FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    mods = _loaded_after("import benchmark.reference.sift, benchmark.reference.vo")
    assert "sift_pyocl_tpu_torch" not in mods and not mods & guard.FORBIDDEN

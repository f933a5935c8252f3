"""The port's tail (the evaluate CLI, the frame source, the native loader,
the fixtures, the long-run fence, the host-loop pipeline) and its demos
import neither jax nor the JAX package: checked in a fresh interpreter,
since this test process has both loaded."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODULES = ["sift_pyocl_tpu_torch.evaluate", "sift_pyocl_tpu_torch.native",
           "sift_pyocl_tpu_torch.utils.framesource", "sift_pyocl_tpu_torch.utils.fixtures",
           "sift_pyocl_tpu_torch.utils.longrun", "sift_pyocl_tpu_torch.sfm.pipeline"]
DEMOS = ["demo_sift_torch", "demo_match_align_torch", "demo_vo_torch", "demo_sfm_torch",
         "demo_evaluate_torch"]

PROBE = """
import importlib, importlib.util, json, sys
sys.path.insert(0, {root!r})
before = set(sys.modules)
for name in {modules!r}:
    importlib.import_module(name)
for name in {demos!r}:
    spec = importlib.util.spec_from_file_location(name, {root!r} + "/examples/" + name + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main), name
new = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "sift_pyocl_tpu"))
print(json.dumps(new))
"""


def test_tail_and_demos_import_no_jax():
    code = PROBE.format(root=str(ROOT), modules=MODULES, demos=DEMOS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

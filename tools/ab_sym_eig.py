"""K12 (``sym_eig_small``) and K13 (``svd3``) on a CUDA card beside the
launch floor, from this tree or from several trees in turns.

    python tools/ab_sym_eig.py                      # this tree
    python tools/ab_sym_eig.py --turns OLD NEW      # OLD, NEW, NEW, OLD

The inputs are chip_smoke.py's: the two-view init's (257, 9, 9) eight-point
A^T A (``linalg_scene``), its first matrix alone (the refit's (1, 9, 9)),
RANSAC-H's (257, 9, 9) DLT A^T A (``linalg_dlt_scene``, where the tree has
it), and K13 on the 257 fits' null vectors (``svd3_257``) and on the
first alone (``svd3_1``: the batch of the refit and of
``decompose_essential``).  For each case:

  * ``ms``: event ms a call (CUDA events over 50 calls, after warm-up);
  * ``device_ms``: the device time of the kernel's launch a call
    (``sym_eig_small_kernel``, ``svd3_kernel``), and ``records``: records
    on the card a call (torch.profiler, fullest of five sessions);
  * ``checksum``: K12's eigenvalues' sum in float64 and the first column's
    absolute sum, K13's U, S and Vh absolute sums, and ``sha1`` the first
    16 hex digits of the outputs' bytes, to see whether the trees compute
    the same bits.

``floor_ms``: the device time of a ``fill_`` of 257 floats, the shortest
launch the card runs; ``eigh_ms``: ``torch.linalg.eigh`` on the (257, 9,
9) set (event ms).

``--turns`` runs this script once a tree (``tools/ab_turns.py``).
Requires a CUDA device.
"""

from __future__ import annotations

import hashlib
import sys

from ab_turns import event_ms, kernel_ms, main


def measure() -> dict:
    import torch

    import chip_smoke as cs
    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.ops.kernels import linalg

    if not torch.cuda.is_available():
        raise SystemExit("ab_sym_eig.py: no CUDA device")
    _build.library()
    dev = torch.device("cuda", 0)
    A = cs.linalg_scene(dev)[0]
    cases = {"eight_point_257": A, "refit_1": A[:1].contiguous()}
    if hasattr(cs, "linalg_dlt_scene"):
        cases["dlt_257"] = cs.linalg_dlt_scene(dev)
    F = linalg.sym_eig_small(A, plain=True)[1][:, :, 0].reshape(-1, 3, 3).contiguous()
    cases.update(svd3_257=F, svd3_1=F[:1].contiguous())
    out = {"torch": torch.__version__}
    for name, M in cases.items():
        eig = not name.startswith("svd3")
        fn = (lambda: linalg.sym_eig_small(M)) if eig else (lambda: linalg.svd3(M))
        dev_ms, _, records = kernel_ms(fn, "sym_eig_small_kernel" if eig else "svd3_kernel")
        got = fn()
        checksum = ([float(got[0].double().sum()), float(got[1][..., 0].double().abs().sum())]
                    if eig else [float(x.double().abs().sum()) for x in got])
        digest = hashlib.sha1(b"".join(x.cpu().numpy().tobytes() for x in got)).hexdigest()
        out[name] = {"ms": event_ms(fn, 50), "device_ms": dev_ms, "records": records,
                     "checksum": checksum, "sha1": digest[:16]}
    x = torch.empty(A.shape[0], device=dev)
    out["floor_ms"] = kernel_ms(lambda: x.fill_(1.0), "")[0]
    out["eigh_ms"] = event_ms(lambda: torch.linalg.eigh(A), 50)
    return out


if __name__ == "__main__":
    sys.exit(main(__doc__, __file__, measure))

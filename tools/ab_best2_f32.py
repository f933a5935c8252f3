"""K7f (best-2 squared-L2 matching on f32 descriptors) on a CUDA card, from
this tree or from several trees in turns.

    python tools/ab_best2_f32.py                      # this tree
    python tools/ab_best2_f32.py --turns OLD NEW      # OLD, NEW, NEW, OLD

The inputs are chip_smoke.py's P8: the keypoint buffers of the first two
frames of the VO scene (``profiling.vo_frames``) at 1080x1920 under
``SiftConfig()``; the map call matches frame 1's 8320 slots against a
2048-slot map of frame 0 (its valid slots first), the keyframe call frame
1's 256 strongest valid slots against frame 0's 8320.  Each as f32 at the
1/512 scale (every partial sum exact, so every design gives the same
bits: ``checksum``) and at 1/255 (sums round).  For each call and scale:

  * ``ms``: event ms a call (CUDA events over 50 calls, after warm-up);
  * ``device_ms``: the mean device time of a ``best2_l2_f32_kernel``
    launch, and ``cuda_launches`` / ``other_launches``: that kernel's
    launches a call and every other record on the card a call
    (torch.profiler, fullest of five sessions, each opened by
    ``profiling.open_session``).

``work``: the grid's blocks that compute (row tiles holding a valid row x
column splits holding a valid column) and the share of their pairs that
are valid rows x valid columns.

``--turns`` runs this script once a tree (``tools/ab_turns.py``).
Requires a CUDA device.
"""

from __future__ import annotations

import sys

from ab_turns import device_events, event_ms, main

SHAPE = (1080, 1920)
KERNEL = "best2_l2_f32_kernel"


def calls(dev):
    """{call name: (desc1, desc2, valid1, valid2) as u8} at P8's shapes."""
    import torch

    from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe
    from sift_pyocl_tpu_torch.utils import profiling

    cfg = SiftConfig()
    f0, f1 = (detect_and_describe(torch.from_numpy(f).to(dev), cfg)
              for f in profiling.vo_frames(SHAPE, 2))
    map_ids = torch.sort((~f0.valid).to(torch.uint8), stable=True).indices[:2048]
    spawn_ids = torch.sort(torch.where(f1.valid, f1.scale, -torch.inf), descending=True,
                           stable=True).indices[:256]
    return {"map": (f1.desc, f0.desc[map_ids].clone(), f1.valid, f0.valid[map_ids].clone()),
            "keyframe": (f1.desc[spawn_ids].clone(), f0.desc, f1.valid[spawn_ids].clone(),
                         f0.valid)}


def work(v1, v2) -> dict:
    """The blocks of K7f's grid (64-row tiles x 128-column splits) that
    compute, and the share of their (row, column) pairs that are valid;
    also the tiles holding a valid row at other tile heights."""
    import torch

    def tiles(v, size):
        pad = torch.zeros(-(-v.shape[0] // size) * size, dtype=torch.bool, device=v.device)
        pad[:v.shape[0]] = v
        return int(pad.view(-1, size).any(1).sum())

    rows, cols = tiles(v1, 64), tiles(v2, 128)
    return {"row_tiles": rows, "col_splits": cols, "blocks": rows * cols,
            "valid_pair_share": int(v1.sum()) * int(v2.sum()) / (rows * 64 * cols * 128),
            "row_tiles_by_height": {h: tiles(v1, h) for h in (16, 32, 64)}}


def measure() -> dict:
    import torch

    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.ops.kernels import matchk

    if not torch.cuda.is_available():
        raise SystemExit("ab_best2_f32.py: no CUDA device")
    _build.library()
    dev = torch.device("cuda", 0)
    out = {"torch": torch.__version__}
    for name, (d1, d2, v1, v2) in calls(dev).items():
        out[name] = {"n1": d1.shape[0], "n2": d2.shape[0], "valid_rows": int(v1.sum()),
                     "valid_cols": int(v2.sum()), "work": work(v1, v2)}
        for scale in (512.0, 255.0):
            a, b = d1.float() / scale, d2.float() / scale
            fn = lambda: matchk.best2_l2_f32(a, b, v2, v1)  # noqa: E731
            n_calls = 5
            ev = device_events(fn, n_calls)
            named = [e for e in ev if KERNEL in e.name]
            got = fn()
            out[name][f"1/{scale:g}"] = {
                "ms": event_ms(fn, 50),
                "device_ms": (sum(e.device_time_total for e in named) / 1e3 / len(named)
                              if named else None),
                "cuda_launches": len(named) / n_calls,
                "other_launches": (len(ev) - len(named)) / n_calls,
                "checksum": [float(got[0][v1].double().sum()), float(got[1][v1].double().sum()),
                             int(got[2][v1].long().sum())]}
    return out


if __name__ == "__main__":
    sys.exit(main(__doc__, __file__, measure))

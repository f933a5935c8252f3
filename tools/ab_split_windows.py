"""K11a and K11b (the split orientation and descriptor histograms) on a CUDA
card, from this tree or from several trees in turns.

    python tools/ab_split_windows.py                      # this tree
    python tools/ab_split_windows.py --turns OLD NEW      # OLD, NEW, NEW, OLD

At 1080x1920 under SiftConfig() (the frame and slots of chip_smoke.py's
P5): per octave the K10a/K10b keypoints, the plain gradient planes padded
by ``pad_grad_planes``, K11a's slots and, at K11a's angles
(``orientation_peaks_dense``), K11b's slots.  For each kernel, over a
frame's 7 wrapper calls:

  * ``closure_ms``: event ms (CUDA events over 20 frames) with sigma made
    in the timed closure, as chip_smoke.py's rows time it;
  * ``prepared_ms``: the same with the slot arrays and sigma made before;
  * ``cuda_launches``: CUDA launches a wrapper call (prepared);
  * ``device_ms``: the kernels' own device time a frame, and
    ``launch_device_ms`` each launch's, octave by octave (torch.profiler,
    fullest of five sessions, each opened by ``profiling.open_session``);
  * ``slots`` / ``valid``: each launch's blocks and valid slots.

``k6_per_octave``: K6 (``orient_desc_fused``) launched once an octave on
the same keypoints' unpadded planes, device ms a frame and a launch: the
same boxes and sums in one launch an octave, a yardstick for the launches'
fixed cost and tails.  ``--turns`` runs this script once a tree
(``tools/ab_turns.py``).  Requires a CUDA device.
"""

from __future__ import annotations

import sys

from ab_turns import event_ms, kernel_ms, main

SHAPE = (1080, 1920)


def measure() -> dict:
    import torch

    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.ops import orient_desc as od
    from sift_pyocl_tpu_torch.ops.detect import detect_octave_pallas
    from sift_pyocl_tpu_torch.ops.kernels import window
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
    from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

    if not torch.cuda.is_available():
        raise SystemExit("ab_split_windows.py: no CUDA device")
    _build.library()
    dev = torch.device("cuda", 0)
    cfg = SiftConfig()
    m = cfg.max_ori
    x = torch.from_numpy(synthetic_scene(SHAPE, seed=0)).to(dev)
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    win_o, win_d = od._ori_window_size(cfg), od._desc_window_size(cfg)
    per = []
    for o, (blurs, dogs) in enumerate(build_scale_space(x, cfg)):
        kps, _ = detect_octave_pallas(dogs, cfg, o, caps[o])
        mags, oris = od.gradient_planes(blurs, cfg)
        mag_p, ori_p = od.pad_grad_planes(mags, oris)
        okps = od.assign_orientations_pallas(mag_p, ori_p, kps, cfg, max_ori=m)
        per.append((kps, mags, oris, mag_p, ori_p, okps))
    torch.cuda.synchronize()

    def ori_args(kps, mags, oris, mag_p, ori_p, okps):
        return (mag_p, ori_p, kps.s_int, kps.fr, kps.fc, od._sigma(cfg, kps.fs), kps.valid,
                win_o)

    def desc_args(kps, mags, oris, mag_p, ori_p, okps):
        return (mag_p, ori_p, okps.s_int, okps.fr, okps.fc, od._sigma(cfg, okps.fs),
                okps.angle, okps.valid, win_d)

    out = {"torch": torch.__version__, "octaves": len(per)}
    for name, args, valid_at in (("orientation_hist", ori_args, 6),
                                 ("descriptor_hist", desc_args, 7)):
        fn = getattr(window, name)
        pre = [args(*p) for p in per]
        call = lambda: [fn(*a) for a in pre]
        dev_ms, each, launches = kernel_ms(call, f"{name}_kernel")
        out[name] = {
            "closure_ms": event_ms(lambda: [fn(*args(*p)) for p in per]),
            "prepared_ms": event_ms(call),
            "cuda_launches": launches / len(per),
            "device_ms": dev_ms, "launch_device_ms": each,
            "slots": [int(a[valid_at].numel()) for a in pre],
            "valid": [int(a[valid_at].sum()) for a in pre]}
    k6 = [(mags.contiguous(), oris.contiguous(), kps.s_int, kps.fr, kps.fc,
           od._sigma(cfg, kps.fs), kps.valid, win_d, m,
           *window.slot_octave_geometry([kps.fr.shape[0]], [0], [mags]))
          for kps, mags, oris, _, _, _ in per]
    dev_ms, each, _ = kernel_ms(lambda: [window.orient_desc_fused(*a) for a in k6],
                                "orient_desc_kernel")
    out["k6_per_octave"] = {"device_ms": dev_ms, "launch_device_ms": each}
    return out


if __name__ == "__main__":
    sys.exit(main(__doc__, __file__, measure))

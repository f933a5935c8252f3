"""Kernel-vs-plain parity on a CUDA card (skipped without one).

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SLICE_CONFIG, detect_and_describe
from sift_pyocl_tpu_torch.models.sift import octave_capacities, to_keypoint_records
from sift_pyocl_tpu_torch.ops.detect import extrema_mask
from sift_pyocl_tpu_torch.ops.kernels import (compact, conv, gradpad, ladder, launch_counts,
                                              maskk, matchk, refine, reset_launch_counts, window)
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets, synthetic_scene

pytestmark = pytest.mark.gpu
CFG = dataclasses.replace(SLICE_CONFIG, kp_per_octave_cap=256)
SHAPE = (240, 320)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def stage_inputs(cuda):
    img = torch.from_numpy(synthetic_scene(SHAPE, n_blobs=30, seed=2)).to(cuda)
    octaves = build_scale_space(img, CFG)
    dogs = [d for _, d in octaves]
    masks = [extrema_mask(d, CFG, o) for o, d in enumerate(dogs)]
    caps = [c for c, _ in octave_capacities(SHAPE, CFG)]
    return img, octaves, dogs, masks, caps


def test_compact_and_refine_kernels_match_plain(stage_inputs):
    """Compaction exact; refinement exact (same operation order, the
    library is built with --fmad=false)."""
    _, _, dogs, masks, caps = stage_inputs
    got = compact.compact_masks_multi(masks, caps)
    want = compact.compact_masks_multi_ref(masks, caps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    args = (dogs, masks, caps, got[0], got[1], CFG.border_dist, CFG.peak_thresh,
            CFG.max_interp_moves)
    out = refine.refine_multi(*args)
    for g, w in zip(out, refine.refine_multi_ref(*args)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(out[5].sum()) > 10
    # one CUDA launch a call, straight from K3's output: nothing else
    assert _cuda_launches(lambda: refine.refine_multi(*args), "refine_kernel") == (3, 0)


def test_grad_and_window_kernels_match_plain(stage_inputs):
    """Gradient atlas exact; orientations within 1e-4 and u8 descriptors
    within 1 count (bins are summed in different orders)."""
    from sift_pyocl_tpu_torch.ops.orient_desc import _desc_window_size, quantize_descriptors

    _, octaves, dogs, masks, caps = stage_inputs
    blurs = [b for b, _ in octaves]
    got = gradpad.grad_atlas(blurs, CFG.scales)
    want = gradpad.grad_atlas_ref(blurs, CFG.scales)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    mag, ori, row_starts = got
    idx, wr, _ = compact.compact_masks_multi(masks, caps)
    s, fs, fr, fc, _, keep = refine.refine_multi(dogs, masks, caps, idx, wr, CFG.border_dist,
                                                 CFG.peak_thresh, CFG.max_interp_moves)
    args = (mag, ori, s, fr, fc, CFG.init_sigma * 2.0 ** (fs / CFG.scales), keep,
            _desc_window_size(CFG), CFG.max_ori,
            *window.slot_octave_geometry(caps, row_starts, blurs))
    ak, okk, rk = window.orient_desc_fused(*args)
    ap, okp, rp = window.orient_desc_fused_ref(*args)
    assert torch.equal(okk, okp) and int(okk.sum()) > 10
    assert float((ak[okk] - ap[okp]).abs().max()) <= 1e-4
    dq = (quantize_descriptors(rk[okk]).int() - quantize_descriptors(rp[okp]).int()).abs()
    assert int(dq.max()) <= 1 and float(dq.float().mean()) < 0.01


def test_slice_kernel_path_matches_plain_path(stage_inputs):
    img = stage_inputs[0]
    reset_launch_counts()
    buf = detect_and_describe(img, CFG)
    counts = launch_counts()
    assert counts.pop("best2_l2") == 0, counts
    assert counts.pop("octave0_ladder") == counts.pop("small_octaves_ladder") == 0, counts
    for name in ("extrema_masks", "compact_mask", "refine_octave", "separable_blur",
                 "orientation_hist", "descriptor_hist", "octave0_ladder_mask",
                 "small_octaves_ladder_mask", "best2_l2_f32"):
        assert counts.pop(name) == 0, counts
    assert all(n == 1 for n in counts.values()), counts

    got = to_keypoint_records(buf)
    want = to_keypoint_records(detect_and_describe(img, CFG, plain=True))
    assert len(got) == len(want) > 10
    hits, l1 = match_keypoint_sets(want, got)
    assert hits == len(want) and l1 < 0.01


@pytest.mark.parametrize("double", [False, True])
def test_mask_kernel_is_exact(stage_inputs, double):
    """K8 equals the plain stencil on every octave, bit for bit (also under
    double_im_size's edge-threshold rule), and K3 takes its masks as they
    are."""
    _, _, dogs, masks, caps = stage_inputs
    cfg = dataclasses.replace(CFG, double_im_size=double)
    got = maskk.extrema_masks(dogs, cfg)
    want = maskk.extrema_masks_ref(dogs, cfg)
    assert len(got) == len(want) == len(dogs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bool and g.data_ptr() % 16 == 0
        assert torch.equal(g, w)
    assert sum(int(w.sum()) for w in want) > 10
    for g, w in zip(compact.compact_masks_multi(got, caps), compact.compact_masks_multi(want, caps)):
        assert torch.equal(g, w)


def test_per_octave_kernels_are_exact(stage_inputs):
    """K10a and K10b equal their plain versions on the octave with the most
    candidates, bit for bit, and the per-octave frontend equals the
    multi-launch one with the plain gradients."""
    img, _, dogs, masks, caps = stage_inputs
    o = max(range(len(masks)), key=lambda i: int(masks[i].sum()))
    got = compact.compact_mask(masks[o], caps[o])
    want = compact.compact_mask_ref(masks[o], caps[o])
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert int(want[1]) > 5
    args = (dogs[o], masks[o], got[0], got[1], CFG.border_dist, CFG.peak_thresh,
            CFG.max_interp_moves)
    for g, w in zip(refine.refine_octave(*args), refine.refine_octave_ref(*args)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # one CUDA launch a call, straight from K10a's output: nothing else
    assert _cuda_launches(lambda: refine.refine_octave(*args), "refine_kernel") == (3, 0)
    per_octave = detect_and_describe(img, dataclasses.replace(CFG, kp_multi_launch=False))
    multi = detect_and_describe(img, dataclasses.replace(CFG, grad_backend="xla"))
    for f in per_octave._fields:
        assert torch.equal(getattr(per_octave, f), getattr(multi, f)), f


@pytest.mark.parametrize("mode", ["shrink", "bin"])
def test_ladder_kernels_match_plain(cuda, mode):
    """K1 and K2 within 1e-3 of their plain versions at 240x320 (and an odd
    size), every octave ceil-sized."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.pyramid import downsample_octave, normalize_image

    cfg = SiftConfig(downsample_mode=mode)
    incs = cfg.sigma_increments()
    pre = float((cfg.init_sigma**2 - cfg.orig_sigma**2) ** 0.5)
    for shape in (SHAPE, (135, 241), (77, 131)):
        x = normalize_image(torch.from_numpy(synthetic_scene(shape, n_blobs=20, seed=4)).to(cuda))
        got = ladder.octave0_ladder(x, pre, incs)
        want = ladder.octave0_ladder_ref(x, pre, incs)
        for g, w in zip(got, want):
            assert g.shape == w.shape and float((g - w).abs().max()) <= 1e-3
        base = downsample_octave(want[0][cfg.scales], mode)
        n_oct = cfg.n_octaves(shape) - 1
        got = ladder.small_octaves_ladder(base, incs, n_oct, cfg.scales, mode)
        want = ladder.small_octaves_ladder_ref(base, incs, n_oct, cfg.scales, mode)
        assert len(got) == len(want) == n_oct
        for (gb, gd), (wb, wd) in zip(got, want):
            assert gb.shape == wb.shape and gd.shape == wd.shape
            assert float((gb - wb).abs().max()) <= 1e-3 and float((gd - wd).abs().max()) <= 1e-3


@pytest.mark.parametrize("n1,n2", [(512, 8320), (8320, 2048), (256, 8320), (37, 1), (64, 1)])
def test_best2_l2_kernel_is_exact(cuda, n1, n2):
    """K7 equals its plain version on valid1 rows bit for bit, past the
    TPU's 8192-column cap, with ties at the minimum (inside one column
    split, and across splits: the lowest column wins) and an all-invalid
    column set; invalid rows come back (0, 0, 0)."""
    rng = np.random.default_rng(n1 + n2)
    d1 = torch.from_numpy(rng.integers(0, 256, (n1, 128), dtype=np.uint8))
    d2 = torch.from_numpy(rng.integers(0, 256, (n2, 128), dtype=np.uint8))
    v1 = torch.from_numpy(rng.uniform(size=n1) < 0.6)
    v2 = torch.from_numpy(rng.uniform(size=n2) < 0.8)
    if n2 > 8:
        d2[5] = d2[3]
        d1[0] = d2[3]
        d2[-1] = d2[-2] = d1[1]
        v1[:2] = True
        v2[[3, 5, -2, -1]] = True
    if n2 > 2 * matchk.SPLIT_COLS + 100:   # row 0's tie also in split 1; row 2's in 1 and 2
        s = matchk.SPLIT_COLS
        d2[s + 44] = d2[3]
        d2[s + 4] = d2[2 * s + 88] = d1[2]
        v1[2] = True
        v2[[s + 44, s + 4, 2 * s + 88]] = True
    d1, d2, v1, v2 = (t.to(cuda) for t in (d1, d2, v1, v2))
    for valid2 in (v2, torch.zeros_like(v2)):
        got = matchk.best2_l2(d1, d2, valid2, v1)
        want = matchk.best2_l2_ref(d1, d2, valid2)
        for a, b in zip(got, want):
            assert torch.equal(a[v1], b[v1])
            assert not a[~v1].any()
        if n2 > 8 and valid2 is v2:
            assert int(got[2][0]) == 3 and float(got[1][0]) == float(got[0][0]) == 0.0
        if n2 > 2 * matchk.SPLIT_COLS + 100 and valid2 is v2:
            assert int(got[2][2]) == matchk.SPLIT_COLS + 4 and float(got[1][2]) == 0.0
    # K7f on the same values as f32 (and mixed): integer sums below 2^24
    # are exact in f32, so it equals K7 bit for bit here
    reset_launch_counts()
    for a, b in ((d1.float(), d2.float()), (d1, d2.float())):
        for g, w in zip(matchk.best2_l2(a, b, v2, v1), matchk.best2_l2(d1, d2, v2, v1)):
            assert torch.equal(g, w)
    assert matchk.best2_l2_f32.launches == 2 and matchk.best2_l2.launches == 2


@pytest.mark.parametrize("n1,n2", [(8320, 2048), (256, 8320), (37, 1)])
def test_best2_l2_f32_kernel_matches_plain(cuda, n1, n2):
    """K7f against its plain version on f32 descriptors whose sums round:
    d1/d2 within 1e-5 of |a|^2 + max |b|^2 (the dot products are summed in
    other orders), i1 equal except at near-ties; invalid rows (0, 0, 0)."""
    rng = np.random.default_rng(n1 + 7 * n2)
    a = torch.from_numpy(rng.random((n1, 128), dtype=np.float32)).to(cuda)
    b = torch.from_numpy(rng.random((n2, 128), dtype=np.float32)).to(cuda)
    v1 = torch.from_numpy(rng.uniform(size=n1) < 0.6).to(cuda)
    v2 = torch.from_numpy(rng.uniform(size=n2) < 0.8).to(cuda)
    got = matchk.best2_l2(a, b, v2, v1)
    want = matchk.best2_l2_ref(a, b, v2)
    mag = (a * a).sum(1) + (b * b).sum(1).max()
    for g, w in zip(got[:2], want[:2]):
        fin = torch.isfinite(w)
        assert torch.equal(fin[v1], torch.isfinite(g)[v1])
        assert bool((((g - w).abs() / mag)[v1 & fin] <= 1e-5).all())
    near = (want[1] - want[0]) <= 1e-5 * mag
    assert not bool((v1 & ~near & (got[2] != want[2])).any())
    assert not any(t[~v1].any() for t in got)


def test_blur_kernel_matches_plain_and_k1(cuda):
    """K9 within 1e-3 of its plain version at SiftConfig(scales=2)'s five
    octave-0 sigmas (up to 39 taps), and the per-level octave 0 bit-equal
    to K1's on the same frame and sigmas (one level kernel)."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops import pyramid as tp

    cfg = SiftConfig(scales=2)
    pre, incs = tp.pre_blur_sigma(cfg), cfg.sigma_increments()
    img = torch.from_numpy(synthetic_scene(SHAPE, n_blobs=20, seed=4)).to(cuda)
    reset_launch_counts()
    blurs, dogs = tp.build_octave(tp.prepare_input(img, cfg, "pallas"), incs, "pallas")
    assert conv.separable_blur.launches == 5
    k1_blurs, k1_dogs = ladder.octave0_ladder(tp.normalized_input(img, cfg), pre, incs)
    assert torch.equal(blurs, k1_blurs) and torch.equal(dogs, k1_dogs)
    for x, s in zip([tp.normalized_input(img, cfg)] + list(blurs[:-1]), (pre,) + incs):
        t = tp._taps(s, cuda)
        got, want = conv.separable_blur(x, t), tp.separable_blur_ref(x, t)
        assert float((got - want).abs().max()) <= 1e-3
    odd = torch.rand(135, 241, device=cuda) * 255
    t = tp._taps(3.09, cuda)
    assert float((conv.separable_blur(odd, t) - tp.separable_blur_ref(odd, t)).abs().max()) <= 1e-3
    reset_launch_counts()
    octaves = tp.build_scale_space(img, cfg)
    assert launch_counts()["separable_blur"] == 5 and launch_counts()["octave0_ladder"] == 0
    for (a, b), (c, d) in zip(octaves, tp.build_scale_space(img, cfg, plain=True)):
        assert float((a - c).abs().max()) <= 1e-3 and float((b - d).abs().max()) <= 1e-3
    # no pre-blur (init_sigma below the doubled input's sigma): octave 0
    # level by level, one K9 launch per increment and no K1
    cfg = SiftConfig(double_im_size=True, init_sigma=0.9)
    assert tp.pre_blur_sigma(cfg) is None
    reset_launch_counts()
    octaves = tp.build_scale_space(img, cfg)
    assert launch_counts()["separable_blur"] == len(cfg.sigma_increments())
    assert launch_counts()["octave0_ladder"] == 0
    for (a, b), (c, d) in zip(octaves, tp.build_scale_space(img, cfg, plain=True)):
        assert float((a - c).abs().max()) <= 1e-3 and float((b - d).abs().max()) <= 1e-3


def test_split_window_kernels_match_plain(stage_inputs):
    """K11a and K11b against their plain versions on every octave's
    keypoints: histograms within 1e-3 of the largest bin, the same oriented
    slots, u8 descriptors within 1 count."""
    from sift_pyocl_tpu_torch.ops import orient_desc as od
    from sift_pyocl_tpu_torch.ops.detect import detect_octave_pallas

    _, octaves, _, _, caps = stage_inputs
    n_ok = 0
    for o, (blurs, dogs) in enumerate(octaves):
        kps, _ = detect_octave_pallas(dogs, CFG, o, caps[o])
        mag_p, ori_p = od.pad_grad_planes(*od.gradient_planes(blurs, CFG))
        sig = od._sigma(CFG, kps.fs)
        args = (mag_p, ori_p, kps.s_int, kps.fr, kps.fc, sig, kps.valid, od._ori_window_size(CFG))
        h, hp = window.orientation_hist(*args), window.orientation_hist_ref(*args)
        assert float((h - hp).abs().max()) <= 1e-3 * max(1.0, float(hp.abs().max()))
        okps = od.orientation_peaks_dense(h, kps, CFG, CFG.max_ori)
        assert torch.equal(okps.valid, od.orientation_peaks_dense(hp, kps, CFG, CFG.max_ori).valid)
        dargs = (mag_p, ori_p, okps.s_int, okps.fr, okps.fc, od._sigma(CFG, okps.fs), okps.angle,
                 okps.valid, od._desc_window_size(CFG))
        dq = (od.quantize_descriptors(window.descriptor_hist(*dargs)).int()
              - od.quantize_descriptors(window.descriptor_hist_ref(*dargs)).int()).abs()
        assert int(dq.max()) <= 1
        n_ok += int(okps.valid.sum())
    assert n_ok > 10


def _split_octaves(stage_inputs):
    """Per octave of the stage inputs: K11a's arguments (padded planes,
    keypoint slots, sigma, the orientation window), and K6's outputs on the
    octave's unpadded planes with K11b's arguments at K6's angles and slots
    (keypoint-major, the descriptor window)."""
    from sift_pyocl_tpu_torch.ops import orient_desc as od
    from sift_pyocl_tpu_torch.ops.detect import detect_octave_pallas

    _, octaves, _, _, caps = stage_inputs
    m, win_d = CFG.max_ori, od._desc_window_size(CFG)
    out = []
    for o, (blurs, dogs) in enumerate(octaves):
        kps, _ = detect_octave_pallas(dogs, CFG, o, caps[o])
        mags, oris = od.gradient_planes(blurs, CFG)
        mag_p, ori_p = od.pad_grad_planes(mags, oris)
        sig = od._sigma(CFG, kps.fs)
        ori_args = (mag_p, ori_p, kps.s_int, kps.fr, kps.fc, sig, kps.valid,
                    od._ori_window_size(CFG))
        k6 = window.orient_desc_fused(mags.contiguous(), oris.contiguous(), kps.s_int, kps.fr,
                                      kps.fc, sig, kps.valid, win_d, m,
                                      *window.slot_octave_geometry([caps[o]], [0], [mags]))

        def rep(x):
            return torch.repeat_interleave(x, m, dim=0)

        desc_args = (mag_p, ori_p, rep(kps.s_int), rep(kps.fr), rep(kps.fc), rep(sig),
                     k6[0].reshape(-1), k6[1].reshape(-1), win_d)
        out.append((ori_args, k6, desc_args))
    return out


def test_split_window_kernels_give_k6_bits_and_launch_once(stage_inputs):
    """K11b at K6's angles and slots gives K6's raw descriptors bit for bit
    (the same 104 window, quad boxes and fixed-order sums); each wrapper
    call is one CUDA launch, and two calls give the same bits."""
    n_ok = 0
    for ori_args, k6, desc_args in _split_octaves(stage_inputs):
        reset_launch_counts()
        h, d = window.orientation_hist(*ori_args), window.descriptor_hist(*desc_args)
        assert torch.equal(h, window.orientation_hist(*ori_args))
        assert torch.equal(d, window.descriptor_hist(*desc_args))
        assert window.orientation_hist.launches == 2 and window.descriptor_hist.launches == 2
        assert torch.equal(d, k6[2].reshape(-1, 128))
        assert _cuda_launches(lambda: window.orientation_hist(*ori_args),
                              "orientation_hist_kernel") == (3, 0)
        assert _cuda_launches(lambda: window.descriptor_hist(*desc_args),
                              "descriptor_hist_kernel") == (3, 0)
        n_ok += int(k6[1].sum())
    assert n_ok > 10


def test_split_window_kernels_all_invalid_and_graph_replay(stage_inputs, cuda):
    """K11a and K11b: every slot invalid gives zeros; captured once in a
    CUDA graph and replayed 5 times on new inputs copied into the captured
    buffers, every replay equals an eager call on the same inputs."""
    ori_args, _, desc_args = max(_split_octaves(stage_inputs),
                                 key=lambda t: int(t[0][6].sum()))
    none = torch.zeros_like(ori_args[6])
    assert not bool(window.orientation_hist(*ori_args[:6], none, ori_args[7]).any())
    none = torch.zeros_like(desc_args[7])
    assert not bool(window.descriptor_hist(*desc_args[:7], none, desc_args[8]).any())
    static_o = [t.clone() if torch.is_tensor(t) else t for t in ori_args]
    static_d = [t.clone() if torch.is_tensor(t) else t for t in desc_args]
    rng = np.random.default_rng(17)

    def new_inputs(args, valid_at):
        a = list(args)
        a[0] = args[0] * float(rng.uniform(0.5, 2.0))
        a[3] = args[3] + torch.from_numpy(rng.uniform(-0.5, 0.5, args[3].shape).astype(
            np.float32)).to(cuda)
        a[valid_at] = args[valid_at] & torch.from_numpy(
            rng.random(args[valid_at].shape[0]) < 0.8).to(cuda)
        return a

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm-up on the capturing stream
        for _ in range(2):
            window.orientation_hist(*static_o)
            window.descriptor_hist(*static_d)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out_o = window.orientation_hist(*static_o)
        out_d = window.descriptor_hist(*static_d)
    for _ in range(5):
        a_o, a_d = new_inputs(ori_args, 6), new_inputs(desc_args, 7)
        for i in (0, 3, 6):
            static_o[i].copy_(a_o[i])
        for i in (0, 3, 7):
            static_d[i].copy_(a_d[i])
        graph.replay()
        want_o, want_d = window.orientation_hist(*a_o), window.descriptor_hist(*a_d)
        torch.cuda.synchronize()
        assert torch.equal(out_o, want_o) and torch.equal(out_d, want_d)


def test_plain_keypoint_path_matches_kernel_path(stage_inputs):
    """kp_backend="xla" on the card launches no keypoint kernel and finds
    the kernel path's keypoints."""
    img = stage_inputs[0]
    reset_launch_counts()
    plain = to_keypoint_records(detect_and_describe(img, dataclasses.replace(CFG, kp_backend="xla")))
    assert sum(launch_counts().values()) == 0       # SLICE_CONFIG: plain pyramid too
    kern = to_keypoint_records(detect_and_describe(img, CFG))
    # the two paths' orientation windows (48 and 104) sum the histograms
    # in other orders: a peak at the 0.8 max threshold may flip
    assert abs(len(plain) - len(kern)) <= max(2, len(kern) // 50) and len(kern) > 10
    hits, l1 = match_keypoint_sets(kern, plain)
    assert hits >= 0.98 * len(kern) and l1 < 0.1


@pytest.mark.parametrize("mode", ["shrink", "bin"])
def test_fused_ladder_masks_are_exact(cuda, mode):
    """K1m and K2m: blurs and DoGs bit-equal to K1's and K2's, every
    octave's mask bit-equal to K8's and to the plain stencil on those DoGs,
    at 240x320 and an odd size."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.pyramid import downsample_octave, normalize_image

    cfg = SiftConfig(downsample_mode=mode, mask_backend="fused")
    incs = cfg.sigma_increments()
    pre = float((cfg.init_sigma**2 - cfg.orig_sigma**2) ** 0.5)
    bd = cfg.border_dist
    for shape in (SHAPE, (135, 241), (77, 131)):
        x = normalize_image(torch.from_numpy(synthetic_scene(shape, n_blobs=20, seed=4)).to(cuda))
        n_oct = cfg.n_octaves(shape)
        b0, d0, m0 = ladder.octave0_ladder(
            x, pre, incs, mask_cfg=(cfg.peak_thresh, maskk.octave_edge_thresh(cfg, 0), bd))
        kb0, kd0 = ladder.octave0_ladder(x, pre, incs)
        assert torch.equal(b0, kb0) and torch.equal(d0, kd0)
        base = downsample_octave(b0[cfg.scales], mode)
        eths = tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct))
        small = ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, mode,
                                            mask_cfg=(cfg.peak_thresh, eths, bd))
        ksmall = ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, mode)
        for (b, d, _), (kb, kd) in zip(small, ksmall):
            assert torch.equal(b, kb) and torch.equal(d, kd)
        dogs = [d0] + [d for _, d, _ in small]
        masks = [m0] + [m for _, _, m in small]
        for m, k, st in zip(masks, maskk.extrema_masks(dogs, cfg), maskk.extrema_masks_ref(dogs, cfg)):
            assert m.dtype == torch.bool and torch.equal(m, k) and torch.equal(m, st)
        assert sum(int(m.sum()) for m in masks) > 10


def test_fused_frontend_equals_default(cuda):
    """detect_and_describe with mask_backend="fused": K1m and K2m once, no
    K1, K2, K8 and no stencil, buffer equal to the default's; with
    scales=2, octave 0 through K9 and the stencil (its mask entry None) and
    the buffer equal to scales=2 without fusion."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops.kernels.maskk import stencil_mask

    img = torch.from_numpy(synthetic_scene(SHAPE, n_blobs=30, seed=2)).to(cuda)
    for kw, stencils in (({}, 0), ({"scales": 2}, 1)):
        cfg = SiftConfig(kp_per_octave_cap=256, **kw)
        want = detect_and_describe(img, cfg)
        reset_launch_counts()
        stencil_mask.calls = 0
        got = detect_and_describe(img, dataclasses.replace(cfg, mask_backend="fused"))
        counts = launch_counts()
        assert stencil_mask.calls == stencils
        assert counts["small_octaves_ladder_mask"] == 1 and counts["small_octaves_ladder"] == 0
        assert counts["octave0_ladder_mask"] == (0 if kw else 1)
        assert counts["octave0_ladder"] == counts["extrema_masks"] == 0
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (kw, f)
        assert int(got.valid.sum()) > 10


def test_mode_arguments_compute_one_function(stage_inputs):
    """K3's extract_mode, K6's reduce_mode and K7's two_pass take the TPU
    kernels' values and give the same results on the card; other values
    raise ValueError."""
    from sift_pyocl_tpu_torch.ops.orient_desc import _desc_window_size

    _, octaves, dogs, masks, caps = stage_inputs
    want = compact.compact_masks_multi(masks, caps)
    for g, w in zip(compact.compact_masks_multi(masks, caps, extract_mode="rowmm"), want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="extract_mode"):
        compact.compact_masks_multi(masks, caps, extract_mode="scan")
    blurs = [b for b, _ in octaves]
    mag, ori, row_starts = gradpad.grad_atlas(blurs, CFG.scales)
    s, fs, fr, fc, _, keep = refine.refine_multi(dogs, masks, caps, want[0], want[1],
                                                 CFG.border_dist, CFG.peak_thresh,
                                                 CFG.max_interp_moves)
    args = (mag, ori, s, fr, fc, CFG.init_sigma * 2.0 ** (fs / CFG.scales), keep,
            _desc_window_size(CFG), CFG.max_ori,
            *window.slot_octave_geometry(caps, row_starts, blurs))
    for g, w in zip(window.orient_desc_fused(*args, reduce_mode="colsum"),
                    window.orient_desc_fused(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="reduce_mode"):
        window.orient_desc_fused(*args, reduce_mode="rows")
    rng = np.random.default_rng(9)
    d1 = torch.from_numpy(rng.integers(0, 256, (300, 128), dtype=np.uint8)).to(mag.device)
    d2 = torch.from_numpy(rng.integers(0, 256, (500, 128), dtype=np.uint8)).to(mag.device)
    v2 = torch.ones(500, dtype=torch.bool, device=mag.device)
    for g, w in zip(matchk.best2_l2(d1, d2, v2, two_pass=True), matchk.best2_l2(d1, d2, v2)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="two_pass"):
        matchk.best2_l2(d1, d2, v2, two_pass="yes")


def _compaction_case(name: str):
    """(masks, caps) of one compaction edge case (numpy, seeded)."""
    from sift_pyocl_tpu_torch.ops.kernels.compact import TILE

    rng = np.random.default_rng(7)
    if name == "empty":
        return [np.zeros((3, 200, 300), bool)], [64]
    if name == "tiles_128_129":
        m = np.zeros(3 * TILE, bool)
        m[rng.choice(TILE, 128, replace=False)] = True
        m[TILE + rng.choice(TILE, 129, replace=False)] = True
        m[2 * TILE + 5] = True
        return [m.reshape(3, -1)], [400]
    if name == "cap_on_tile_boundary":
        m = rng.random(6 * TILE) < 0.002            # ~65 a tile, none past 128
        kept = m.reshape(6, TILE).sum(1)
        return [m], [int(kept[:3].sum())]
    if name == "more_tiles_than_sms":
        return [rng.random((3, 1070, 1910)) < 1e-3, rng.random((9, 1000, 1000)) < 2e-4], [2048, 3000]
    # lengths not a multiple of 4 or of the tile, and an empty mask
    return ([rng.random(3 * TILE + 4093) < 0.01, rng.random(4097) < 0.05,
             np.zeros(0, bool), rng.random(7) < 0.5], [1200, 100, 3, 4])


@pytest.mark.parametrize("name", ["empty", "tiles_128_129", "cap_on_tile_boundary",
                                  "more_tiles_than_sms", "ragged"])
def test_compaction_edge_cases_are_exact(cuda, name):
    """K3 and K10a equal their plain versions exactly (indices, written,
    total, zeros past written) at the tile rule's and the cap's edges."""
    masks, caps = _compaction_case(name)
    ms = [torch.from_numpy(m).to(cuda) for m in masks]
    reset_launch_counts()
    for g, w in zip(compact.compact_masks_multi(ms, caps), compact.compact_masks_multi_ref(ms, caps)):
        assert g.shape == w.shape and torch.equal(g, w), name
    for m, cap in zip(ms, caps):
        for g, w in zip(compact.compact_mask(m, cap), compact.compact_mask_ref(m, cap)):
            assert g.shape == w.shape and torch.equal(g, w), name
    assert compact.compact_masks_multi.launches == 1
    assert compact.compact_mask.launches == len(ms)


def test_compaction_repeated_calls_are_exact(cuda):
    """50 calls in a row on one stream, of changing sizes (each call's
    tiles fewer or more than the last's, so the status words of earlier
    calls are still there), each equal to the plain version: the kernel's
    ticket and epoch leave its scratch ready for the next call."""
    rng = np.random.default_rng(11)
    for i in range(50):
        n_oct = int(rng.integers(1, 4))
        masks = [torch.from_numpy(rng.random(int(rng.integers(1, 400_000))) < 3e-3).to(cuda)
                 for _ in range(n_oct)]
        caps = [int(rng.integers(0, 1500)) for _ in range(n_oct)]
        for g, w in zip(compact.compact_masks_multi(masks, caps),
                        compact.compact_masks_multi_ref(masks, caps)):
            assert torch.equal(g, w), i


def test_compaction_and_small_octaves_replay_in_a_cuda_graph(cuda):
    """K3 and K2 captured once in a CUDA graph and replayed 5 times on new
    inputs copied into the captured buffers: every replay equals an eager
    call on the same inputs (the compaction's epoch advances on the device)."""
    from sift_pyocl_tpu_torch import SiftConfig

    cfg = SiftConfig()
    incs = cfg.sigma_increments()
    rng = np.random.default_rng(12)

    def inputs():
        masks = [torch.from_numpy(rng.random(s) < 2e-3).to(cuda)
                 for s in ((3, 300, 500), (3, 150, 250), (3, 75, 125))]
        base = torch.from_numpy(rng.random((271, 483), dtype=np.float32) * 255).to(cuda)
        return masks, base

    caps = [512, 256, 128]
    masks, base = inputs()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm-up on the capturing stream
        for _ in range(2):
            compact.compact_masks_multi(masks, caps)
            ladder.small_octaves_ladder(base, incs, 4, cfg.scales, "shrink")
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out_c = compact.compact_masks_multi(masks, caps)
        out_l = ladder.small_octaves_ladder(base, incs, 4, cfg.scales, "shrink")
    for _ in range(5):
        new_masks, new_base = inputs()
        for m, n in zip(masks, new_masks):
            m.copy_(n)
        base.copy_(new_base)
        graph.replay()
        want_c = compact.compact_masks_multi(new_masks, caps)
        want_l = ladder.small_octaves_ladder(new_base, incs, 4, cfg.scales, "shrink")
        torch.cuda.synchronize()
        for g, w in zip(out_c, want_c):
            assert torch.equal(g, w)
        for (gb, gd), (wb, wd) in zip(out_l, want_l):
            assert torch.equal(gb, wb) and torch.equal(gd, wd)


def _refine_edge_octaves(rng, cfg, cuda):
    """DoG stacks and masks for K4/K10b's edge cases (numpy, seeded): four
    odd-sized octaves of 5 planes; octave 0 a quadratic bowl centred
    outside the plane (plus noise), so moves run into the clamp, its mask's
    border rows and columns set and more bits than its cap (written ==
    cap); octave 1 an empty mask (written == 0); octaves 2 and 3 noise with
    sparse masks, octave 3's mask one 3 x 3 plane.  Returns (dogs, masks,
    caps)."""
    bd = cfg.border_dist
    shapes = [(5, 37, 53), (5, 23, 19), (5, 17, 29), (5, 13, 13)]
    dogs, masks = [], []
    for o, (S, H, W) in enumerate(shapes):
        d = rng.normal(0, 0.05 if o == 0 else 4.0, (S, H, W))
        m = np.zeros((S - 2, H - 2 * bd, W - 2 * bd), bool)
        if o == 0:
            s_, r_, c_ = np.meshgrid(np.arange(S), np.arange(H), np.arange(W), indexing="ij")
            d += 0.2 * ((r_ + 9.0) ** 2 + (c_ - W - 7.0) ** 2) - 3.0 * (s_ - 2.2) ** 2
            m[:, [0, -1], :] = True
            m[:, :, [0, -1]] = True
        elif o > 1:
            m = rng.random(m.shape) < 0.1
        dogs.append(torch.from_numpy(d.astype(np.float32)).to(cuda))
        masks.append(torch.from_numpy(m).to(cuda))
    return dogs, masks, [64, 16, 48, 16]


def test_refine_kernels_edge_cases_and_graph_replay(cuda):
    """K4 and K10b straight from K3's / K10a's output, bit-equal to their
    plain versions on odd octave sizes, an octave at written == cap, one at
    written == 0 and candidates on the clamp border; one CUDA launch a
    call; then K3 + K4 and K10a + K10b captured in one CUDA graph and
    replayed 5 times on new DoGs and masks, each replay equal to an eager
    call."""
    from sift_pyocl_tpu_torch import SiftConfig

    cfg = SiftConfig()
    bd, pt, mm = cfg.border_dist, cfg.peak_thresh, cfg.max_interp_moves
    rng = np.random.default_rng(23)
    dogs, masks, caps = _refine_edge_octaves(rng, cfg, cuda)
    idx, wr, _ = compact.compact_masks_multi(masks, caps)
    assert wr.tolist()[:2] == [caps[0], 0] and int(wr[2]) > 0
    reset_launch_counts()
    got = refine.refine_multi(dogs, masks, caps, idx, wr, bd, pt, mm)
    want = refine.refine_multi_ref(dogs, masks, caps, idx, wr, bd, pt, mm)
    for f, g, w in zip(("s_int", "fs", "fr", "fc", "peak", "keep"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f"K4 {f} differs"
    assert int(want[5].sum()) > 3 and refine.refine_multi.launches == 1
    for o, (d, m, cap) in enumerate(zip(dogs, masks, caps)):
        i1, w1, _ = compact.compact_mask(m, cap)
        for g, w in zip(refine.refine_octave(d, m, i1, w1, bd, pt, mm),
                        refine.refine_octave_ref(d, m, i1, w1, bd, pt, mm)):
            assert g.dtype == w.dtype and torch.equal(g, w), f"K10b octave {o} differs"
    assert refine.refine_octave.launches == len(dogs)
    assert _cuda_launches(lambda: refine.refine_multi(dogs, masks, caps, idx, wr, bd, pt, mm),
                          "refine_kernel") == (3, 0)

    def both(ds, ms):
        i, w, _ = compact.compact_masks_multi(ms, caps)
        i0, w0, _ = compact.compact_mask(ms[0], caps[0])
        return (refine.refine_multi(ds, ms, caps, i, w, bd, pt, mm),
                refine.refine_octave(ds[0], ms[0], i0, w0, bd, pt, mm))

    static_d, static_m = [d.clone() for d in dogs], [m.clone() for m in masks]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm-up on the capturing stream
        for _ in range(2):
            both(static_d, static_m)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = both(static_d, static_m)
    for i in range(5):
        new_d, new_m, _ = _refine_edge_octaves(rng, cfg, cuda)
        for t, n in zip(static_d + static_m, new_d + new_m):
            t.copy_(n)
        graph.replay()
        eager = both(new_d, new_m)
        torch.cuda.synchronize()
        for k, (g_out, w_out) in enumerate(zip(out, eager)):
            for g, w in zip(g_out, w_out):
                assert torch.equal(g, w), f"replay {i}: {('K4', 'K10b')[k]} differs"


@pytest.mark.parametrize("shape,n_oct,scales,mode", [
    ((541, 963), 6, 3, "shrink"), ((541, 963), 6, 2, "bin"), ((135, 241), 1, 3, "bin"),
    ((135, 241), 1, 2, "shrink"), ((77, 131), 3, 3, "bin"), ((77, 131), 3, 2, "shrink")])
def test_small_octaves_ladder_is_k2m_bit_for_bit(cuda, shape, n_oct, scales, mode):
    """K2 in one launch: its blur and DoG stacks bit-equal to K2m's (K2's
    body, whose work list also holds mask items) and within 1e-3 of the
    plain ladder, at odd sizes, one and six octaves, scales 2 and 3, both
    downsamples."""
    from sift_pyocl_tpu_torch import SiftConfig

    cfg = SiftConfig(scales=scales, downsample_mode=mode)
    incs = cfg.sigma_increments()
    base = torch.from_numpy(synthetic_scene(shape, n_blobs=20, seed=6)).to(cuda) / 255.0
    eths = tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct + 1))
    reset_launch_counts()
    got = ladder.small_octaves_ladder(base, incs, n_oct, scales, mode)
    k2m = ladder.small_octaves_ladder(base, incs, n_oct, scales, mode,
                                      mask_cfg=(cfg.peak_thresh, eths, cfg.border_dist))
    want = ladder.small_octaves_ladder_ref(base, incs, n_oct, scales, mode)
    assert ladder.small_octaves_ladder.launches == 1
    assert len(got) == len(k2m) == len(want) == n_oct
    for (gb, gd), (mb, md, _), (wb, wd) in zip(got, k2m, want):
        assert gb.shape == wb.shape and gd.shape == wd.shape
        assert torch.equal(gb, mb) and torch.equal(gd, md)
        assert float((gb - wb).abs().max()) <= 1e-3 and float((gd - wd).abs().max()) <= 1e-3


def _k6_args(stage_inputs, win: int, max_ori: int, corners: bool = True):
    """K6's arguments on the stage inputs' keypoints; with `corners`, the
    first valid slots of each octave moved to its four corners (boxes the
    octave clips)."""
    _, octaves, dogs, masks, caps = stage_inputs
    blurs = [b for b, _ in octaves]
    mag, ori, row_starts = gradpad.grad_atlas(blurs, CFG.scales)
    idx, wr, _ = compact.compact_masks_multi(masks, caps)
    s, fs, fr, fc, _, kvalid = refine.refine_multi(dogs, masks, caps, idx, wr, CFG.border_dist,
                                                   CFG.peak_thresh, CFG.max_interp_moves)
    fr, fc = fr.clone(), fc.clone()
    if corners:
        off = 0
        for o, cap in enumerate(caps):
            h, w = blurs[o].shape[-2:]
            slots = off + torch.nonzero(kvalid[off:off + cap]).flatten()[:4]
            for slot, (y, x) in zip(slots.tolist(), ((0.2, 0.4), (0.3, w - 0.6),
                                                      (h - 1.3, 0.1), (h - 0.55, w - 0.52))):
                fr[slot], fc[slot] = y, x
            off += cap
    sigma = CFG.init_sigma * 2.0 ** (fs / CFG.scales)
    return (mag, ori, s, fr, fc, sigma, kvalid, win, max_ori,
            *window.slot_octave_geometry(caps, row_starts, blurs))


def _k6_close(got, want) -> int:
    """K6's gates against its plain version (as chip_smoke.py's): ok flags
    equal up to near-tie peaks, angles within 1e-4, u8 descriptors within 1
    count with mean < 0.01.  Returns the ok slots."""
    from sift_pyocl_tpu_torch.ops.orient_desc import quantize_descriptors

    (ak, okk, rk), (ap, okp, rp) = got, want
    n_ok = int(okp.sum())
    assert int((okk != okp).sum()) <= max(1, n_ok // 500)
    both = okk & okp
    if not bool(both.any()):
        return n_ok
    da = (ak[both] - ap[both]).abs()
    assert float(torch.minimum(da, 2 * np.pi - da).max()) <= 1e-4
    dq = (quantize_descriptors(rk[both]).int() - quantize_descriptors(rp[both]).int()).abs()
    assert int(dq.max()) <= 1 and float(dq.float().mean()) < 0.01
    assert not bool(rk[~okk].any())
    return n_ok


@pytest.mark.parametrize("win,max_ori", [(16, 2), (80, 2), (104, 1), (104, 2), (104, 8),
                                         (136, 2)])
def test_orient_desc_kernel_matches_plain_and_repeats(stage_inputs, win, max_ori):
    """K6 (one launch, each keypoint's own support boxes) within its
    tolerances of the plain version at windows 16-136 and max_ori 1, 2, 8,
    with keypoints at every octave's corners; two calls give the same
    bits."""
    args = _k6_args(stage_inputs, win, max_ori)
    reset_launch_counts()
    got = window.orient_desc_fused(*args)
    again = window.orient_desc_fused(*args)
    assert window.orient_desc_fused.launches == 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert _k6_close(got, window.orient_desc_fused_ref(*args)) > 10


def test_orient_desc_kernel_all_invalid(stage_inputs):
    """Every slot invalid: zeros everywhere."""
    args = list(_k6_args(stage_inputs, 104, 2, corners=False))
    args[6] = torch.zeros_like(args[6])
    ang, ok, desc = window.orient_desc_fused(*args)
    assert not bool(ang.any()) and not bool(ok.any()) and not bool(desc.any())


LADDER_SHAPES = [(135, 241), (77, 131), (7, 11)]   # odd; the last below a tap half-width


@pytest.mark.parametrize("scales", [2, 3, 4])
@pytest.mark.parametrize("shape", LADDER_SHAPES)
def test_octave0_ladder_is_k1m_and_k9_bit_for_bit(cuda, shape, scales):
    """K1 (staged, unrolled level body) bit-equal to K1m's stacks (K1's
    launches, then K8's mask kernel) and to the same levels through K9, and
    within 1e-3 of the plain ladder, at odd sizes, a plane smaller than a
    tap half-width, scales 2, 3 and 4 (up to 39 taps)."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops import pyramid as tp

    cfg = SiftConfig(scales=scales)
    pre, incs = tp.pre_blur_sigma(cfg), cfg.sigma_increments()
    x = tp.normalize_image(torch.from_numpy(synthetic_scene(shape, n_blobs=20, seed=4)).to(cuda))
    reset_launch_counts()
    b, d = ladder.octave0_ladder(x, pre, incs)
    assert ladder.octave0_ladder.launches == 1
    mb, md, _ = ladder.octave0_ladder(x, pre, incs, mask_cfg=(cfg.peak_thresh, 10.0, 1))
    assert torch.equal(b, mb) and torch.equal(d, md)
    level = conv.separable_blur(x, tp._taps(pre, cuda))
    assert torch.equal(level, b[0])
    for lv, s in enumerate(incs):
        nxt = conv.separable_blur(b[lv], tp._taps(s, cuda))
        assert torch.equal(nxt, b[lv + 1]) and torch.equal(nxt - b[lv], d[lv])
    rb, rd = ladder.octave0_ladder_ref(x, pre, incs)
    assert float((b - rb).abs().max()) <= 1e-3 and float((d - rd).abs().max()) <= 1e-3


def test_orient_desc_and_octave0_ladder_replay_in_a_cuda_graph(stage_inputs, cuda):
    """K6 and K1 captured once in a CUDA graph and replayed 5 times on new
    inputs copied into the captured buffers: every replay equals an eager
    call on the same inputs."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops import pyramid as tp

    cfg = SiftConfig()
    pre, incs = tp.pre_blur_sigma(cfg), cfg.sigma_increments()
    args = list(_k6_args(stage_inputs, 104, 2))
    static = [t.clone() if torch.is_tensor(t) else t for t in args]
    rng = np.random.default_rng(13)
    img = torch.from_numpy(rng.random((271, 483), dtype=np.float32) * 255).to(cuda)

    def new_inputs():
        a = list(args)
        a[0] = args[0] * float(rng.uniform(0.5, 2.0))
        a[3] = args[3] + torch.from_numpy(rng.uniform(-0.5, 0.5, args[3].shape).astype(
            np.float32)).to(cuda)
        a[6] = args[6] & torch.from_numpy(rng.random(args[6].shape[0]) < 0.8).to(cuda)
        return a, torch.from_numpy(rng.random((271, 483), dtype=np.float32) * 255).to(cuda)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm-up on the capturing stream
        for _ in range(2):
            window.orient_desc_fused(*static)
            ladder.octave0_ladder(img, pre, incs)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out_w = window.orient_desc_fused(*static)
        out_l = ladder.octave0_ladder(img, pre, incs)
    for _ in range(5):
        a, new_img = new_inputs()
        for i in (0, 3, 6):
            static[i].copy_(a[i])
        img.copy_(new_img)
        graph.replay()
        want_w = window.orient_desc_fused(*a)
        want_l = ladder.octave0_ladder(new_img, pre, incs)
        torch.cuda.synchronize()
        for g, w in zip(out_w, want_w):
            assert torch.equal(g, w)
        for g, w in zip(out_l, want_l):
            assert torch.equal(g, w)


def test_grad_atlas_replays_in_a_cuda_graph(stage_inputs, cuda):
    """K5 captured once in a CUDA graph (it needs no first call: no scratch,
    no table) and replayed 5 times on new blur stacks copied into the
    captured buffers: every replay equals an eager call bit for bit."""
    _, octaves, _, _, _ = stage_inputs
    blurs = [b.clone() for b, _ in octaves]
    rng = np.random.default_rng(14)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        mag, ori, rows = gradpad.grad_atlas(blurs, CFG.scales)
    for _ in range(5):
        new = [b * float(rng.uniform(0.5, 2.0)) + torch.from_numpy(
            rng.normal(0.0, 1.0, b.shape).astype(np.float32)).to(cuda) for b, _ in octaves]
        for b, n in zip(blurs, new):
            b.copy_(n)
        graph.replay()
        want = gradpad.grad_atlas(new, CFG.scales)
        torch.cuda.synchronize()
        assert torch.equal(mag, want[0]) and torch.equal(ori, want[1]) and rows == want[2]


def _cuda_launches(fn, name: str, calls: int = 3):
    """(launches of kernels named `name`, other CUDA launches: kernels,
    memsets, copies) that torch.profiler records over `calls` calls of
    fn(), each the most of five sessions.  A session now and then loses a
    record, and a lost record only ever lowers a count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    named = other = 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        named = max(named, sum(name in e.name for e in events))
        other = max(other, sum(name not in e.name for e in events))
    return named, other


def _vo_like_match_inputs(rng, n1, n2, cuda):
    """u8 descriptors with the VO step's validity: valid slots in leading
    blocks of each 1024-slot octave block (rows), all or most columns."""
    d1 = torch.from_numpy(rng.integers(0, 256, (n1, 128), dtype=np.uint8)).to(cuda)
    d2 = torch.from_numpy(rng.integers(0, 256, (n2, 128), dtype=np.uint8)).to(cuda)
    v1 = torch.from_numpy(np.arange(n1) % 1024 < rng.integers(100, 300)).to(cuda)
    v2 = torch.from_numpy(np.arange(n2) % 1024 < rng.integers(150, 1024)).to(cuda)
    return d1, d2, v1, v2


def _assert_graph_replays(fn, inputs, make, keep_v1: bool):
    """fn(desc1, desc2, valid2, valid1) captured in a CUDA graph on
    `inputs` and replayed 5 times on new inputs from make() (desc1, desc2,
    valid1, valid2; valid1 kept as given with `keep_v1`), each replay equal
    to an eager call."""
    static = [t.clone() for t in inputs]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm-up on the capturing stream
        for _ in range(2):
            fn(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn(*static)
    for _ in range(5):
        new = make()
        new = (new[0], new[1], new[3], inputs[3] if keep_v1 else new[2])
        for t, n in zip(static, new):
            t.copy_(n)
        graph.replay()
        eager = fn(*new)
        torch.cuda.synchronize()
        for f, g, w in zip(("d1", "d2", "i1"), out, eager):
            assert torch.equal(g, w), f"replay {f}: {int((g != w).sum())} rows differ"


@pytest.mark.parametrize("n1,n2,single", [(8320, 2048, False), (256, 8320, False),
                                          (256, 8320, True)])
def test_best2_l2_one_launch_repeats_and_replays(cuda, n1, n2, single):
    """K7 at both VO call shapes (and with a single valid row in a row
    tile): bit-equal to its plain version, one CUDA launch a call, the same
    bits on two calls, and captured in a CUDA graph and replayed 5 times
    on new inputs, each replay equal to an eager call."""
    rng = np.random.default_rng(n1 * 3 + n2 + single)
    d1, d2, v1, v2 = _vo_like_match_inputs(rng, n1, n2, cuda)
    if single:
        v1 = torch.zeros_like(v1)
        v1[130] = True
    got = matchk.best2_l2(d1, d2, v2, v1)
    want = matchk.best2_l2_ref(d1, d2, v2)
    again = matchk.best2_l2(d1, d2, v2, v1)
    for f, g, w, a in zip(("d1", "d2", "i1"), got, want, again):
        assert torch.equal(g[v1], w[v1]), f"{f}: {int((g != w)[v1].sum())} valid rows differ"
        assert not g[~v1].any() and torch.equal(g, a), f"{f}: invalid rows or a second call"
    # one launch a call: only the kernel, at most once a call (the wrapper
    # launches it once by construction), nothing else
    reset_launch_counts()
    named, other = _cuda_launches(lambda: matchk.best2_l2(d1, d2, v2, v1), "best2_l2_kernel")
    assert other == 0 and 1 <= named <= 3 and matchk.best2_l2.launches == 16, (named, other)

    _assert_graph_replays(matchk.best2_l2, (d1, d2, v2, v1),
                          lambda: _vo_like_match_inputs(rng, n1, n2, cuda), single)


def _f32_match_inputs(rng, n1, n2, cuda):
    """K7f's inputs with the VO step's validity: u8 values over 255 as f32,
    so the products and their sums round."""
    d1, d2, v1, v2 = _vo_like_match_inputs(rng, n1, n2, cuda)
    return d1.float() / 255.0, d2.float() / 255.0, v1, v2


@pytest.mark.parametrize("n1,n2,single", [(8320, 2048, False), (256, 8320, False),
                                          (256, 8320, True)])
def test_best2_l2_f32_one_launch_k7_bits_repeats_and_replays(cuda, n1, n2, single):
    """K7f at the VO map call's shape, the keyframe call's, and with a
    single valid row in a row tile: within 1e-5 of |a|^2 + max |b|^2 of its
    plain version on f32 values whose sums round (i1 equal off near-ties);
    on integer-valued f32, and on the same integers over 512, K7's bits
    (ties at the minimum planted inside one column split and across two);
    one CUDA launch a call and nothing else; the same bits on two calls;
    and captured in a CUDA graph and replayed 5 times on new inputs, each
    replay equal to an eager call."""
    rng = np.random.default_rng(n1 * 5 + n2 + single)
    u1, u2, v1, v2 = _vo_like_match_inputs(rng, n1, n2, cuda)
    if single:
        v1 = torch.zeros_like(v1)
        v1[130] = True
    ra, rb = (torch.nonzero(v1).flatten().tolist() + [130])[:2]
    s = matchk.SPLIT_COLS
    u2[5] = u2[3]                       # row ra: tied at columns 3 and 5 (split 0)
    u1[ra] = u2[3]
    u2[s + 4] = u2[2 * s + 88] = u1[rb]  # row rb: tied in splits 1 and 2
    v2[[3, 5, s + 4, 2 * s + 88]] = True
    for a, b, scale in ((u1.float(), u2.float(), 1.0), (u1.float() / 512, u2.float() / 512,
                                                          2.0 ** 18)):
        got = matchk.best2_l2_f32(a, b, v2, v1)
        want = matchk.best2_l2(u1, u2, v2, v1)
        for f, g, w in zip(("d1", "d2", "i1"), got, want):
            g = g * scale if f != "i1" else g
            assert torch.equal(g, w), f"{f} (1/{scale:g}): {int((g != w).sum())} rows differ from K7"
    assert int(got[2][ra]) == 3 and float(got[0][ra]) == float(got[1][ra]) == 0.0
    if rb != ra:
        assert int(got[2][rb]) == s + 4 and float(got[0][rb]) == float(got[1][rb]) == 0.0

    a, b, _, _ = _f32_match_inputs(rng, n1, n2, cuda)
    got = matchk.best2_l2_f32(a, b, v2, v1)
    again = matchk.best2_l2_f32(a, b, v2, v1)
    want = matchk.best2_l2_ref(a, b, v2)
    mag = (a * a).sum(1) + (b * b).sum(1).max()
    for g, w in zip(got[:2], want[:2]):
        assert bool((((g - w).abs() / mag)[v1] <= 1e-5).all())
    near = (want[1] - want[0]) <= 1e-5 * mag
    assert not bool((v1 & ~near & (got[2] != want[2])).any())
    for f, g, w in zip(("d1", "d2", "i1"), got, again):
        assert not g[~v1].any() and torch.equal(g, w), f"{f}: invalid rows or a second call"
    reset_launch_counts()
    named, other = _cuda_launches(lambda: matchk.best2_l2_f32(a, b, v2, v1),
                                  "best2_l2_f32_kernel")
    assert other == 0 and 1 <= named <= 3 and matchk.best2_l2_f32.launches == 16, (named, other)

    _assert_graph_replays(matchk.best2_l2_f32, (a, b, v2, v1),
                          lambda: _f32_match_inputs(rng, n1, n2, cuda), single)


def _mask_edge_octaves(rng, cfg, cuda):
    """DoG stacks (5 planes) for K8's edge cases, one "octave" each: an odd
    size; one smaller than a tile; plateaus (values on a coarse grid, so
    neighbours are often equal: strictness decides); and isolated peaks
    of exactly the strong threshold, one f32 step above it, and their
    negatives (the threshold is strict).  The last two have widths that
    are multiples of 4, so some of their tiles stage by 16-byte copies."""
    thr = np.float32(0.8 * cfg.peak_thresh)
    above = np.nextafter(thr, np.float32(np.inf))
    odd = rng.normal(0, 3, (5, 47, 83)).astype(np.float32)
    small = rng.normal(0, 3, (5, 17, 19)).astype(np.float32)
    plateau = (rng.integers(-4, 5, (5, 80, 144)) * 0.9).astype(np.float32)
    peaks = (rng.normal(0, 0.1, (5, 40, 72))).astype(np.float32)
    for k, v in enumerate((thr, above, -thr, -above) * 6):
        r, c = 6 + 5 * (k // 6), 6 + 10 * (k % 6)
        peaks[2, r, c] = v
    return [torch.from_numpy(a).to(cuda) for a in (odd, small, plateau, peaks)]


def test_mask_kernel_edge_cases_and_graph_replay(cuda):
    """K8 bit-equal to the plain stencil on odd sizes, an octave smaller
    than one tile, plateaus and values exactly at the strong threshold;
    captured in a CUDA graph and replayed 5 times on new DoGs, each replay
    equal to an eager call."""
    from sift_pyocl_tpu_torch import SiftConfig

    cfg = SiftConfig()
    rng = np.random.default_rng(21)
    dogs = _mask_edge_octaves(rng, cfg, cuda)
    got = maskk.extrema_masks(dogs, cfg)
    want = maskk.extrema_masks_ref(dogs, cfg)
    for o, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == torch.bool and torch.equal(g, w), f"octave {o} differs"
    assert int(want[3].sum()) == 12          # the peaks one step above the threshold
    assert all(int(w.sum()) > 0 for w in want[:3])
    reset_launch_counts()
    named, other = _cuda_launches(lambda: maskk.extrema_masks(dogs, cfg), "mask_kernel")
    assert other == 0 and 1 <= named <= 3 and maskk.extrema_masks.launches == 16, (named, other)

    static = [d.clone() for d in dogs]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            maskk.extrema_masks(static, cfg)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = maskk.extrema_masks(static, cfg)
    for _ in range(5):
        new = _mask_edge_octaves(rng, cfg, cuda)
        for t, n in zip(static, new):
            t.copy_(n)
        graph.replay()
        eager = maskk.extrema_masks(new, cfg)
        torch.cuda.synchronize()
        for o, (g, w) in enumerate(zip(out, eager)):
            assert torch.equal(g, w), f"replay: octave {o} differs"


@pytest.mark.parametrize("mode", ["shrink", "bin"])
@pytest.mark.parametrize("scales", [2, 3, 4])
def test_fused_masks_match_stencil_and_k8(cuda, scales, mode):
    """K1m's and K2m's masks bit-equal to the plain stencil and to K8 on
    their own DoGs, and their stacks bit-equal to K1's and K2's, at scales
    2, 3 and 4 (4 to 6 DoG planes: K8's tile holds the whole stack), both
    downsamples, odd sizes and octaves smaller than one 32 x 64 mask tile
    (77x131's octaves 1-2, 23x37's octave 1)."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops import pyramid as tp

    cfg = SiftConfig(scales=scales, downsample_mode=mode, mask_backend="fused")
    pre, incs, bd = tp.pre_blur_sigma(cfg), cfg.sigma_increments(), cfg.border_dist
    n_hits = 0
    for shape, n_oct in (((135, 241), None), ((77, 131), 3), ((23, 37), 2)):
        n_oct = n_oct or cfg.n_octaves(shape)
        img = torch.from_numpy(synthetic_scene(shape, n_blobs=20, seed=7 + scales)).to(cuda)
        x = tp.normalize_image(img)
        b0, d0, m0 = ladder.octave0_ladder(
            x, pre, incs, mask_cfg=(cfg.peak_thresh, maskk.octave_edge_thresh(cfg, 0), bd))
        kb0, kd0 = ladder.octave0_ladder(x, pre, incs)
        assert torch.equal(b0, kb0) and torch.equal(d0, kd0), shape
        base = tp.downsample_octave(b0[cfg.scales], mode)
        eths = tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct))
        small = ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, mode,
                                            mask_cfg=(cfg.peak_thresh, eths, bd))
        for o, ((b, d, _), (kb, kd)) in enumerate(zip(
                small, ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, mode))):
            assert torch.equal(b, kb) and torch.equal(d, kd), (shape, o + 1)
        dogs = [d0] + [d for _, d, _ in small]
        masks = [m0] + [m for _, _, m in small]
        assert len(masks) == n_oct and all(m.shape[0] == scales for m in masks)
        k8 = maskk.extrema_masks(dogs, cfg)
        for o, (m, k, d) in enumerate(zip(masks, k8, dogs)):
            st = maskk.extrema_mask(d, cfg, o)
            assert m.dtype == torch.bool and torch.equal(m, st), \
                f"{shape} octave {o}: {int((m != st).sum())} pixels differ from the stencil"
            assert torch.equal(m, k), f"{shape} octave {o}: differs from K8"
            n_hits += int(m.sum())
    assert n_hits > 10


def test_fused_ladders_launch_once_and_replay_in_a_cuda_graph(cuda):
    """K2m is one CUDA launch a call (its cooperative kernel, nothing else)
    and K1m at most seven (K1's six level launches and K8's mask kernel),
    counted by torch.profiler (each count the most of five sessions, since
    a session may lose a record); both captured in a CUDA graph and
    replayed 5 times on new images, every replay bit-equal to an eager
    call."""
    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.ops import pyramid as tp

    cfg = SiftConfig(mask_backend="fused")
    shape = (271, 483)
    n_oct = cfg.n_octaves(shape)
    pre, incs, bd = tp.pre_blur_sigma(cfg), cfg.sigma_increments(), cfg.border_dist
    mc0 = (cfg.peak_thresh, maskk.octave_edge_thresh(cfg, 0), bd)
    mc = (cfg.peak_thresh, tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct)), bd)
    rng = np.random.default_rng(31)

    def new_image():
        scene = synthetic_scene(shape, n_blobs=30, seed=int(rng.integers(1 << 30)))
        return tp.normalize_image(torch.from_numpy(scene).to(cuda))

    x = new_image()
    base = tp.downsample_octave(ladder.octave0_ladder(x, pre, incs)[0][cfg.scales], "shrink")
    reset_launch_counts()
    k2m = lambda: ladder.small_octaves_ladder(base, incs, n_oct - 1, cfg.scales, "shrink", mc)
    named, other = _cuda_launches(k2m, "small_octaves_kernel")
    assert other == 0 and 1 <= named <= 3, (named, other)
    assert ladder.small_octaves_ladder_mask.launches == 16
    k1m = lambda: ladder.octave0_ladder(x, pre, incs, mc0)
    blur, not_blur = _cuda_launches(k1m, "blur_level_kernel")
    mask, not_mask = _cuda_launches(k1m, "mask_kernel")
    assert 1 <= mask <= 3 and not_blur <= 3 and blur <= 6 * 3 and not_mask <= 6 * 3, \
        (blur, not_blur, mask, not_mask)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm-up on the capturing stream
        for _ in range(2):
            k1m()
            k2m()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out1 = k1m()
        out2 = k2m()
    for _ in range(5):
        nx = new_image()
        nbase = tp.downsample_octave(ladder.octave0_ladder(nx, pre, incs)[0][cfg.scales], "shrink")
        x.copy_(nx)
        base.copy_(nbase)
        graph.replay()
        want1 = ladder.octave0_ladder(nx, pre, incs, mc0)
        want2 = ladder.small_octaves_ladder(nbase, incs, n_oct - 1, cfg.scales, "shrink", mc)
        torch.cuda.synchronize()
        for g, w in zip(out1, want1):
            assert torch.equal(g, w), "K1m replay"
        for o, (gs, ws) in enumerate(zip(out2, want2)):
            for g, w in zip(gs, ws):
                assert torch.equal(g, w), f"K2m replay, octave {o + 1}"


def test_small_octaves_mask_reads_no_stale_data(cuda):
    """K2m reads DoGs that other blocks wrote earlier in the same launch:
    called on buffers that just held other data (a K2m call on another
    image, then junk of the same sizes: NaN, +-inf, 1e30), it gives the
    masks of a call on a fresh pool, equal to the stencil on its DoGs."""
    from sift_pyocl_tpu_torch import SiftConfig

    cfg = SiftConfig(mask_backend="fused")
    incs, bd = cfg.sigma_increments(), cfg.border_dist
    shape, n_oct = (540, 960), 6
    mc = (cfg.peak_thresh, tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct + 1)),
          bd)
    rng = np.random.default_rng(41)
    bases = [torch.from_numpy(synthetic_scene(shape, n_blobs=60, seed=s)).to(cuda) / 255.0
             for s in (1, 2, 3)]
    fresh = [[m.clone() for _, _, m in ladder.small_octaves_ladder(b, incs, n_oct, 3, "shrink",
                                                                   mc)]
             for b in bases]
    torch.cuda.synchronize()
    for i, b in enumerate(bases):
        other = ladder.small_octaves_ladder(bases[(i + 1) % 3], incs, n_oct, 3, "shrink", mc)
        shapes = [t.shape for oct_ in other for t in oct_]
        del other
        junk = [torch.full(s, float(rng.choice([np.nan, np.inf, -np.inf, 1e30])), device=cuda)
                for s in shapes]
        del junk
        got = ladder.small_octaves_ladder(b, incs, n_oct, 3, "shrink", mc)
        torch.cuda.synchronize()
        for o, ((_, d, m), f) in enumerate(zip(got, fresh[i])):
            assert torch.equal(m, f), f"image {i}, octave {o + 1}: masks differ on a reused pool"
            assert torch.equal(m, maskk.stencil_mask(d, cfg.peak_thresh, mc[1][o], bd))

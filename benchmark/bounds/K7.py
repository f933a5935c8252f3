"""K7 best2_l2 (csrc/matchk.cu), u8 descriptors on the int8 tensor cores:
each call's two descriptor sets and validity read once, 12 bytes a row
written; 2 x 128 integer operations a (valid row, valid column) pair
(chip_smoke.py::check_matcher).  A VO step makes two calls: the frame
against the window map, the spawned points against the keyframe."""

from benchmark.harness.peaks import INT8_OPS


def calls(f):
    return [(rows * 128 + cols * 128 + rows + cols + 12 * rows, 2 * 128 * vr * vc, INT8_OPS)
            for rows, vr, cols, vc in f["k7"]]

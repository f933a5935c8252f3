"""kernels.roofline_share: the hand-written kernels' bound ms (each
kernel's bound file, summed over the traced frames' calls) over their
device ms, in %.  A kernel with no bound file adds its time to the
denominator alone, so the share can fall but never pass 100 % by it."""


def read(ctx):
    ms = sum(r[2] - r[1] for r, kid in zip(ctx["session"]["records"], ctx["ids"]) if kid) * 1e-3
    if not ms or not ctx["bound_ms"]:
        return None
    return 100.0 * sum(ctx["bound_ms"].values()) / ms

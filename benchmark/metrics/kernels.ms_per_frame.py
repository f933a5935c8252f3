"""kernels.ms_per_frame: device ms a traced frame of the hand-written
kernels (K1-K13, by the kernel-name table)."""


def read(ctx):
    ms = sum(r[2] - r[1] for r, kid in zip(ctx["session"]["records"], ctx["ids"]) if kid) * 1e-3
    return ms / ctx["frames"] if ms else None

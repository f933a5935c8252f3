"""torch_ops.ms_per_frame: device ms a traced frame of every kernel whose
name matches no hand-written kernel (PyTorch's, cuBLAS's, cuDNN's)."""


def read(ctx):
    ms = sum(r[2] - r[1] for r, kid in zip(ctx["session"]["records"], ctx["ids"])
             if r[3] == "kernel" and kid is None) * 1e-3
    return ms / ctx["frames"]

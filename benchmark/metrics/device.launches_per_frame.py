"""device.launches_per_frame: device records (kernels, copies, sets) a
traced frame."""


def read(ctx):
    return len(ctx["session"]["records"]) / ctx["frames"]

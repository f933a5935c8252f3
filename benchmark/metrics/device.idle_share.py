"""device.idle_share: the share of the traced window's wall time in which
no kernel, copy or set ran on the device (1 - the union of the records'
intervals over the window), in %."""

from benchmark.harness import trace


def read(ctx):
    s = ctx["session"]
    return 100.0 * (1.0 - trace.busy_us(s) / trace.window_us(s))

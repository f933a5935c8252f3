"""graphs.captures: CUDA graphs the entry's caches (``GraphCache.captures``)
captured inside the window, read before and after it."""


def read(ctx):
    return ctx["captures"]

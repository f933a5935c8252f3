"""api.host_ms_per_frame: host ms a frame inside the calls into the port
(the harness's ``api`` spans, host clock, no synchronisation added),
over every frame of the window outside the profiling sessions."""


def read(ctx):
    if not ctx["frames_done"]:
        return None
    return 1e3 * ctx["api_host_s"] / ctx["frames_done"]

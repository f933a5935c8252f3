"""copies.ms_per_frame: device ms a traced frame of host-to-device and
device-to-host copies (the trace's ``Memcpy HtoD`` / ``Memcpy DtoH``
records)."""


def read(ctx):
    ms = sum(b - a for name, a, b, kind in ctx["session"]["records"]
             if kind == "memcpy" and ("HtoD" in name or "DtoH" in name)) * 1e-3
    return ms / ctx["frames"]

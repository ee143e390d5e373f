"""Mean ms a call's thread worked, its span less its waits on the device
(profiler runtime records of the traced window)."""

from h100_bench import trace


def read(run):
    return trace.host_work_ms(run.window) if run.window is not None else None

"""Share of the traced window in which the device ran no kernel and no
copy, in % (the union of the profiler's device spans)."""

from h100_bench import trace


def read(run):
    return trace.idle_share(run.window) if run.window is not None else None

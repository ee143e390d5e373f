"""K1's share of its roofline, in %: the least seconds of the traced
calls' work (``roofline.py``) over the kernel's device seconds; nothing
when the window's records of the kernel are short of its launches."""

from h100_bench import trace


def read(run):
    if run.window is None or run.direction != "encode":
        return None
    seconds = trace.kernel_seconds(run.window)
    return 100.0 * run.trace_least_s / seconds if seconds else None

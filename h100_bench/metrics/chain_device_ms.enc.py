"""Mean device-busy ms a call outside the FLCT kernel: staging copies,
tiling, k0, compaction, word rows, assembly, copies back (profiler device
records of the traced window)."""

from h100_bench import trace


def read(run):
    return trace.chain_device_ms(run.window) if run.window is not None else None

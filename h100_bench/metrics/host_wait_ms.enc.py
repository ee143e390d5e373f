"""Mean ms a call's thread was blocked on a device event (the program's
``felics.wait`` spans)."""

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "felics.wait")

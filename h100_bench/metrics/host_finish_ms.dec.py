"""Mean ms a call's thread spent finishing on the host (the program's
``felics.finish.*`` spans): removing an encoded payload's word padding,
building the containers, copying decoded images out of pinned memory."""

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "felics.finish.")

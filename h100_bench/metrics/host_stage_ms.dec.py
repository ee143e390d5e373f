"""Mean ms a call's thread spent staging (the program's ``felics.stage.*``
spans): headers, tile dims, container parsing and checks, grouping by
geometry, and filling pinned host memory with a batch's bytes."""

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "felics.stage.")

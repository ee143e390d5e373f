"""Host spans of the port, on torch.profiler's clock.

``span(name)`` marks a stretch of host work. While no profiler records it
returns ``OFF``, one shared no-op context, at the cost of one check; while
one records it returns ``torch.profiler.record_function(name)``, which that
profiler keeps in memory beside its device records, on the same clock, so
an idle stretch of the device lies on one time axis with the host span open
across it. Nothing is written anywhere: whoever profiles reads the spans
from their own profiler (``prof.events()``, ``prof.export_chrome_trace``).

A span wraps host work only. A range that encloses a kernel launch, a copy
to or from the device, or a graph's capture or replay comes back from the
profiler a second time, as a device-side annotation over the work launched
in it, and would read as device time. Device work is named by its own
kernels and copies. Spans are named by what the host does:

    felics.stage.group      headers, tile dims, container parsing and checks,
                            grouping by geometry
    felics.stage.key        a same-shape group's graph key (before the graph
                            cache, which may capture)
    felics.stage.fill       a batch's bytes written into pinned host memory
    felics.wait             the thread blocked on a device event
    felics.finish.strip     the exact payload copied out of pinned memory
    felics.finish.redo.width
                            a stream outgrew the width hint: the redo
                            counted and the exact width, before the relaunch
    felics.finish.redo.capacity
                            the payload outgrew its capacity: the redo
                            counted, before the compaction at the exact size
    felics.finish.pack      the containers built
    felics.finish.copy_out  decoded images copied out of pinned memory
"""

from __future__ import annotations

import contextlib

import torch

OFF = contextlib.nullcontext()


def span(name: str):
    """A context recording ``name`` as a host span while a profiler records;
    ``OFF`` otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return OFF
    return torch.profiler.record_function(name)

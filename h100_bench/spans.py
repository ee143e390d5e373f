"""The program's host spans in a traced window (``felics_tpu_torch.spans``):
the union of those whose name starts with a prefix, in ms a call. A window
of a program without such spans gives None."""

from __future__ import annotations

from typing import Optional

from h100_bench import trace


def span_ms(run, prefix: str) -> Optional[float]:
    """Mean ms a traced call spent in spans named ``prefix...``, nested and
    overlapping ones counted once; None where the window holds none."""
    w = run.window
    if w is None:
        return None
    spans = [(s, e) for n, s, e in w.host if n.startswith(prefix)]
    return trace.covered(spans) / w.calls / 1e3 if spans else None

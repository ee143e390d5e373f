"""Share of the traced geometry groups whose encode was redone, in %: the
program's ``felics.finish.redo.*`` spans (a relaunch at the exact width or
a compaction at the exact size, each on the call's critical path) over its
``felics.stage.key`` spans, one a group. Nothing for a program that
declares no redo spans (``tiling.REDO_SPANS``), or a window without groups."""

GROUP_SPAN = "felics.stage.key"
REDO_PREFIX = "felics.finish.redo."


def read(run):
    from felics_tpu_torch.parallel import tiling

    w = run.window
    if w is None or run.direction != "encode" or not getattr(tiling, "REDO_SPANS", None):
        return None
    groups = sum(n == GROUP_SPAN for n, _, _ in w.host)
    redos = sum(n.startswith(REDO_PREFIX) for n, _, _ in w.host)
    return 100.0 * redos / groups if groups else None

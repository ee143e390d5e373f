"""Share of the window's geometry groups that replayed a CUDA graph, in %:
the program's replay counter over the groups the harness counted."""


def read(run):
    return 100.0 * run.replays / run.groups if run.groups else None

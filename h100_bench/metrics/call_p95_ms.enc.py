"""95th percentile, in ms, of the latency of every call of the ingest
window, from the call until its containers are on the host. The ingest
cell's calls are host work around one graph replay, so this tail follows
the host's state from run to run more than the throughput does; it is
read here, beside the per-layer numbers, rather than held to a bound."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3 if run.latencies else None

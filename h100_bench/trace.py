"""The traced window: torch.profiler over a run of calls, and the numbers
the per-layer readers take from it.

The profiler is kept in memory and nothing is written to disk. On some
H100 hosts a profiled window comes back with a few device records missing;
a window whose records of the cell's kernel are fewer than the launches
the program counted is profiled again by the caller, up to ``TRIES``
windows. Kernel
numbers are read only from a window that holds every launch's record.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

TRIES = 3
# Host calls in which the caller thread waits on the device.
BLOCKING = ("cudaEventSynchronize", "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpy")
CALL_SPAN = "h100_bench.call"


@dataclass
class Window:
    """What one traced window holds, reduced to spans (microseconds on the
    profiler's clock)."""

    calls: int
    wall_s: float
    call_spans: List[Tuple[float, float]]
    device: List[Tuple[str, float, float]]  # (name, start, end)
    blocking: List[Tuple[float, float]]
    host: List[Tuple[str, float, float]]  # every host op, for the idle gaps
    launches: int  # launches of the cell's kernel the program counted
    kernel: str

    def kernel_spans(self) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e in self.device if self.kernel in n]

    def complete(self) -> bool:
        """Whether every counted launch of the kernel has a device record."""
        return self.launches > 0 and len(self.kernel_spans()) >= self.launches


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(spans: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in union(spans))


def profile(run_calls: Callable[[int], None], n_calls: int, kernel: str,
            launches: Callable[[], int]) -> Window:
    """One window: ``run_calls(n_calls)`` under torch.profiler (CPU and
    CUDA activities), reduced, with the launches of ``kernel`` that the
    program counted in it (``launches()`` before and after)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    before = launches()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_calls(n_calls)
        wall = time.perf_counter() - t0
    return reduce(prof.events(), n_calls, wall, kernel, launches() - before)


def reduce(events, n_calls: int, wall_s: float, kernel: str, launches: int) -> Window:
    calls, device, blocking, host = [], [], [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.name == CALL_SPAN:  # the harness's span, on the host and as a device annotation
            if e.device_type.name != "CUDA":
                calls.append((s, t))
        elif e.device_type.name == "CUDA":
            device.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
            if e.name in BLOCKING:
                blocking.append((s, t))
    return Window(n_calls, wall_s, sorted(calls), device, blocking, host, launches, kernel)


# ---------------------------------------------------------------------------
# Numbers of a window
# ---------------------------------------------------------------------------


def span_bounds(w: Window) -> Tuple[float, float]:
    return w.call_spans[0][0], w.call_spans[-1][1]


def busy_us(w: Window) -> float:
    """Microseconds of the window in which the device ran anything."""
    lo, hi = span_bounds(w)
    return covered([(max(s, lo), min(e, hi)) for _, s, e in w.device if e > lo and s < hi])


def window_us(w: Window) -> float:
    lo, hi = span_bounds(w)
    return hi - lo


def host_work_ms(w: Window) -> Optional[float]:
    """Mean ms a call's thread worked: the call's span less the time it
    spent blocked in a wait on the device."""
    if not w.call_spans:
        return None
    total = sum(e - s for s, e in w.call_spans) - covered(w.blocking)
    return total / len(w.call_spans) / 1e3


def chain_device_ms(w: Window) -> Optional[float]:
    """Mean device-busy ms a call outside the codec's kernel."""
    spans = [(s, e) for n, s, e in w.device if w.kernel not in n]
    if not w.device:
        return None
    return covered(spans) / w.calls / 1e3


def kernel_seconds(w: Window) -> Optional[float]:
    """The kernel's device seconds in the window, or None when its records
    are short of the launches counted."""
    if not w.complete():
        return None
    return sum(e - s for s, e in w.kernel_spans()) / 1e6


def idle_share(w: Window) -> Optional[float]:
    if not w.device or not w.call_spans:
        return None
    return 100.0 * (1.0 - busy_us(w) / window_us(w))


def short(name: str, limit: int = 96) -> str:
    """A device op's name without its return type, cut to ``limit``."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[: limit - 3] + "..."


def breakdown(w: Window, top: int = 10) -> Dict:
    """The device operations with the most time, and the longest idle gaps
    of the device named by what the host was doing in their middle: the
    shortest host op that spans it, or, where none does, Python after the
    last host op that ended before it."""
    by_name: Dict[str, float] = {}
    for n, s, e in w.device:
        by_name[short(n)] = by_name.get(short(n), 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    if not w.call_spans:
        return {"device_ops": [list(o) for o in ops], "idle_gaps": []}
    lo, hi = span_bounds(w)
    gaps, cur = [], lo
    for s, e in union([(s, e) for _, s, e in w.device]) + [(hi, hi)]:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        over = [(t1 - t0, n) for n, t0, t1 in w.host if t0 <= mid <= t1]
        if over:
            named.append([min(over)[1], (e - s) / 1e6])
            continue
        before = [(t1, n) for n, t0, t1 in w.host if t1 < mid]
        named.append([f"python after {max(before)[1]}" if before else "python", (e - s) / 1e6])
    return {"device_ops": [list(o) for o in ops], "idle_gaps": named}

"""The core of the benchmark: one cell, one seed, one run.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``: container, colour, depth and,
for FLCT, tile) and a traffic mix (``traffic/<traffic>.json``: the
driver, image sizes and counts and the call's size). What is particular
to a container (its kernels and their launch counters, its payload, its
geometry groups, its reference and its controls) is read from
``containers/<container>.py``. The run:

1. set-up: makes a pool of photograph-like images from the seed on the card
   (``traffic/images.py``), hands it to the mix's driver
   (``drivers/<driver>.py``; a serve driver encodes the pool with the code
   under test), and warms on calls drawn from the seed (every pass over
   the pool a fresh permutation cut into calls), block after block, until
   a block neither captures a graph nor changes how many replay;
2. the window: one caller thread issues further fresh draws back to back
   (a closed loop) for ``--seconds``, so that graph keys and payload sizes
   vary as fresh traffic makes them vary; a key first met here is met
   here, and the window counts the graphs captured in it; the last call
   started in time is waited for and counted;
3. with ``--trace 1``, a further window of the mix's ``trace_calls`` calls
   under torch.profiler (``trace.py``);
4. the check: a sample of the window's calls, drawn from the seed, held to
   the plain reference (``check.py``), after the device memory peak is
   read.

It prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``, each read by ``metrics/<metric>.py``) as the last
line of standard output, with each number compared and its limit last.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "felics_tpu")
# Set-up warms on fresh draws in blocks of WARM_BLOCK calls until a block
# captures no graph and replays as many as the block before, at most
# MAX_WARM_BLOCKS blocks: what a fresh service has met by then.
WARM_BLOCK = 32
MAX_WARM_BLOCKS = 8
# glibc's mallopt parameters that a configuration's ``heap`` block may fix.
MALLOPT = {"mmap_threshold_bytes": -3, "trim_threshold_bytes": -1}


class RunError(Exception):
    """A run that cannot give a result (no card, JAX loaded, bad cell)."""


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def read_bench(path: Path = ROOT / "BENCHMARK.json") -> Dict:
    with open(path) as f:
        return json.load(f)


def listed(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its configuration, mix and
    the metrics it reports."""
    bench = bench or read_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if listed(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and listed(m, name)]
    return make_cell(name, w["chips"], ROOT / conf["file"], w["traffic"], e2e, per_layer)


def make_cell(name: str, chips: int, config_file: Path, traffic: str,
              e2e: List[Dict], per_layer: List[Dict]) -> Cell:
    """A cell from its configuration's file and its mix's name."""
    with open(config_file) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return Cell(name, chips, config, mix, e2e, per_layer)


def set_heap(config: Dict) -> None:
    """Fix glibc's heap thresholds where the configuration's deployment
    states them (its ``heap`` block); a configuration without the block
    runs under glibc's own adjustment, and another libc is left alone."""
    import ctypes

    heap = config.get("heap", {})
    if not heap:
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    for name, value in heap.items():
        if not libc.mallopt(MALLOPT[name], int(value)):
            raise RunError(f"mallopt refused {name}={value}")


def load_file(path: Path):
    """The module in ``path`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"h100_bench._{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_container(config: Dict):
    """The module of the configuration's container (FLCT where it names
    none)."""
    return load_file(BENCH_DIR / "containers" / f"{config.get('container', 'flct')}.py")


def draws(seed: int, n_pool: int, per_call: int) -> Iterator[List[int]]:
    """Calls of ``per_call`` pool indices, without end: each pass over the
    pool a fresh seeded permutation, cut into calls, so that every seed
    codes the same images as often, grouped differently every pass."""
    if n_pool % per_call:
        raise RunError("a mix's pool must split into whole calls")
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    while True:
        perm = rng.permutation(n_pool)
        for i in range(0, n_pool, per_call):
            yield perm[i : i + per_call].tolist()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def smi(fields: str) -> str:
    """One line of nvidia-smi's answer for ``fields``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


@dataclass
class Run:
    """What one run measured: the readers of per-layer metrics take their
    numbers from here."""

    direction: str
    window_s: float = 0.0
    calls: int = 0
    pixels: int = 0
    latencies: List[float] = field(default_factory=list)
    ends: List[float] = field(default_factory=list)  # each call's return, s into the window
    call_px: List[int] = field(default_factory=list)
    groups: int = 0  # geometry groups dispatched in the window
    replays: int = 0  # graph replays the program counted in the window
    captures: int = 0
    window: object = None  # trace.Window of the traced calls
    trace_least_s: float = 0.0  # roofline least seconds of the traced calls' work
    warm_calls: int = 0
    clocks: str = ""  # the card's clocks as the window closed


def geometry_groups(driver, items, pool, container, config) -> int:
    """Geometry groups the entry point dispatches for a call: per batch,
    what the container groups by."""
    return sum(container.groups([pool[i] for i in chunk], config)
               for chunk in driver.chunks(items))


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
             t_start: float, substitute: Optional[Callable] = None):
    """(result dict, checks) of one run; ``substitute(driver, items)``
    replaces the driver's call (the controls)."""
    import torch

    from h100_bench import check, roofline, trace
    from h100_bench.traffic import images
    from felics_tpu_torch.parallel import graphs

    mix, conf = cell.mix, cell.config
    container = load_container(conf)
    drv = load_file(BENCH_DIR / "drivers" / f"{mix['driver']}.py")
    direction = drv.DIRECTION
    rgb, depth = conf["color"] == "rgb", int(conf["depth"])
    pool = images.make_pool(seed, [tuple(s) for s in mix["sizes"]], mix["counts"], rgb,
                            depth, device)
    tile = (tuple(conf["tile"]),) if "tile" in conf else ()
    driver = drv.Driver(pool, *tile, mix, device)
    call = driver.call if substitute is None else (lambda items: substitute(driver, items))
    stream = draws(seed, len(pool), mix["batch"])
    px = [int(im.shape[0]) * int(im.shape[1]) for im in pool]
    sample_bytes = 2 if depth == 16 else 1
    payload: Dict[int, int] = {}
    if direction == "decode":
        payload = {i: container.payload_bytes(c) for i, c in enumerate(driver.containers)}

    run = Run(direction)
    prev = None
    for block in range(1, MAX_WARM_BLOCKS + 1):
        r0, c0 = graphs.REPLAYS[direction], graphs.CAPTURES[direction]
        for _ in range(WARM_BLOCK):
            items = next(stream)
            out = call(items)
            run.warm_calls += 1
            if direction == "encode":
                for i, blob in zip(items, out):
                    payload.setdefault(i, container.payload_bytes(blob))
        now = (graphs.CAPTURES[direction] - c0, graphs.REPLAYS[direction] - r0)
        if block >= 2 and now[0] == 0 and now[1] == prev[1]:
            break
        prev = now
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # The window: a closed loop over fresh draws.
    sampler = random.Random(int(seed) * 7919 + 17)
    sample, k = [], int(mix["sample_calls"])
    failed, attempted, errors, issued = 0, 0, [], []
    r0, c0 = graphs.REPLAYS[direction], graphs.CAPTURES[direction]
    t0 = time.perf_counter()
    end, t_done, n = t0 + seconds, t0, 0
    while t_done < end:
        items = next(stream)
        t = time.perf_counter()
        try:
            out = call(items)
        except Exception as e:  # a failed call counts its images, and the run goes on
            out = e
            errors.append(repr(e))
            failed += len(items)
        t_done = time.perf_counter()
        run.latencies.append(t_done - t)
        run.ends.append(t_done - t0)
        issued.append(items)
        if n < k:
            sample.append((items, out))
        else:
            r = sampler.randrange(n + 1)
            if r < k:
                sample[r] = (items, out)
        n += 1
    run.calls, run.window_s = n, t_done - t0
    run.replays = graphs.REPLAYS[direction] - r0
    run.captures = graphs.CAPTURES[direction] - c0
    if device.type == "cuda":
        run.clocks = smi("clocks.sm,clocks.mem,pstate,power.draw")
    attempted = sum(len(items) for items in issued)
    run.call_px = [sum(px[i] for i in items) for items in issued]
    run.pixels = sum(run.call_px)
    run.groups = sum(geometry_groups(driver, items, pool, container, conf) for items in issued)

    if trace_on:
        traced_items: List[List[int]] = []

        def traced(count):
            for _ in range(count):
                items = next(stream)
                with torch.profiler.record_function(trace.CALL_SPAN):
                    out = call(items)
                traced_items.append(items)
                if direction == "encode":
                    for i, blob in zip(items, out):
                        if i not in payload:
                            payload[i] = container.payload_bytes(blob)

        kernel = container.KERNELS[direction]
        tries = []
        for _ in range(trace.TRIES):
            traced_items.clear()
            run.window = trace.profile(
                traced, int(mix["trace_calls"]), kernel, lambda: container.launches(direction))
            tries.append((len(run.window.kernel_spans()), run.window.launches))
            if run.window.complete():
                break
        print(f"[h100_bench] traced windows of {mix['trace_calls']} calls: {len(tries)} "
              f"taken, the last used; {kernel} device records / launches counted per "
              f"window: {tries}", flush=True)
        run.trace_least_s = sum(
            roofline.call_least_seconds([pool[i].shape for i in items], sample_bytes,
                                        [payload[i] for i in items])
            for items in traced_items)

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.compare(direction, sample, pool, container.reference(pool, conf, device),
                           getattr(driver, "containers", None))
    result = {
        "check_s": time.perf_counter() - t_check,
        "run": run, "setup_s": setup_s, "attempted": attempted, "failed": failed,
        "errors": errors[:3], "memory_peak_bytes": memory_peak,
    }
    return result, checks


def end_to_end(run: Run, setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics the core computes."""
    lat = sorted(run.latencies)
    out = {"setup_s": setup_s}
    if lat:
        out["call_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    if run.window_s > 0:
        out[f"{run.direction}_mpx_s"] = run.pixels / 1e6 / run.window_s
    return out


def quarter_rates(run: Run) -> List[float]:
    """Mpx/s of the calls that returned in each quarter of the window: how
    far the rate moved within the run."""
    q = run.window_s / 4
    if q <= 0:
        return []
    px = [0] * 4
    for end, n in zip(run.ends, run.call_px):
        px[min(3, int(end / q))] += n
    return [n / 1e6 / q for n in px]


def per_layer(cell: Cell, run: Run) -> Dict[str, float]:
    """Each per-layer metric of the cell its reader finds something for."""
    out = {}
    for m in cell.per_layer:
        v = load_file(BENCH_DIR / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            out[m["name"]] = float(v)
    return out


def report(cell: Cell, trace_on: bool, result: Dict, checks: Dict, device) -> Dict:
    """The result line."""
    import torch

    from h100_bench import check, trace

    run: Run = result["run"]
    if trace_on:
        values, entries = per_layer(cell, run), cell.per_layer
    else:
        values, entries = end_to_end(run, result["setup_s"]), cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in entries if m["name"] in values}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = {"correct": check.correct(checks) and result["failed"] == 0,
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    if trace_on and run.window is not None:
        w = run.window
        dev["busy_s"] = trace.busy_us(w) / 1e6 if w.call_spans else 0.0
        dev["window_s"] = trace.window_us(w) / 1e6 if w.call_spans else w.wall_s
        line["breakdown"] = trace.breakdown(w)
    line["card"] = smi("name,power.limit") if device.type == "cuda" else "cpu"
    line["window"] = {"calls": run.calls, "seconds": run.window_s,
                      "call_p50_ms": float(np.median(run.latencies)) * 1e3 if run.latencies else None,
                      "graph_replays": run.replays, "graph_captures": run.captures,
                      "groups": run.groups, "warm_calls": run.warm_calls,
                      "quarter_mpx_s": quarter_rates(run),
                      "setup_s": result["setup_s"], "check_s": result["check_s"],
                      "clocks_at_close": run.clocks}
    if result["errors"]:
        line["errors"] = result["errors"]
    line["checks"] = checks
    return line


def main(args, t_start: float) -> int:
    """Run the cell of ``args`` on the card and print its result line;
    nonzero, with no result, without a card or with JAX loaded."""
    try:
        cell = load_cell(args.workload)
        set_heap(cell.config)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} CUDA device(s); "
                           f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                  t_start)
        line = report(cell, bool(args.trace), result, checks, device)
        found = forbidden_modules()
        if found:
            raise RunError(f"modules of JAX or the JAX package are loaded: {found}")
    except RunError as e:
        print(f"h100_bench: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(line), flush=True)
    from h100_bench import check
    for text in check.lines(checks):
        print(text, file=sys.stderr, flush=True)
    return 0

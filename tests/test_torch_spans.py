"""The port's host spans (felics_tpu_torch/spans.py) and the counters of
its FLCT host path, on the CPU.

Under torch.profiler the batched and streamed entry points record one
``felics.stage.group`` a call or chunk and one ``felics.stage.key``,
``felics.stage.fill``, ``felics.finish.strip`` and ``felics.finish.pack``
(encode) or ``felics.finish.copy_out`` (decode) a geometry group; no span
encloses an op that can move data to a device or launch work there, so
the profiler never files a span as device time. With no profiler running a span is one
shared no-op. ``tiling.EAGER`` counts the groups that ran the eager chain,
``tiling.REDOS`` the synchronous redos of ``shard_finish``, and
``GraphCache.evictions`` the graphs a cache evicted. The card's side (a
graph path's spans stay host events) is in tests/test_torch_flct_cuda.py.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from felics_tpu_torch import spans
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.ops import tile_codec as tcd
from felics_tpu_torch.parallel import batch, graphs, tiling

CPU = torch.device("cpu")
TC = TileConfig(8, 8)
# Ops that move data to a device or launch work there when the data is on one.
DEVICE_OPS = {"aten::to", "aten::_to_copy", "aten::copy_", "aten::cat"}


def _images():
    """Two geometry groups: three 24x20 images (8x8 tiles), two 6x6 ones
    (6x6 tiles)."""
    rng = np.random.default_rng(70)
    return ([rng.integers(0, 256, (24, 20), dtype=np.uint8) for _ in range(3)]
            + [rng.integers(0, 256, (6, 6), dtype=np.uint8) for _ in range(2)])


BLOBS = batch.compress_tiled_batch(_images(), TC, device=CPU)

# entry point, its call, the spans it records: a call or chunk has one
# group span, a geometry group one of each other span
ENTRIES = {
    "compress_tiled_batch": (
        lambda: batch.compress_tiled_batch(_images(), TC, device=CPU),
        {"felics.stage.group": 1, "felics.stage.key": 2, "felics.stage.fill": 2,
         "felics.finish.strip": 2, "felics.finish.pack": 2}),
    "decompress_tiled_batch": (
        lambda: batch.decompress_tiled_batch(BLOBS, device=CPU),
        {"felics.stage.group": 1, "felics.stage.key": 2, "felics.stage.fill": 2,
         "felics.finish.copy_out": 2}),
    "decompress_tiled_stream": (  # chunks of one group and of two
        lambda: batch.decompress_tiled_stream([BLOBS[:2], BLOBS[2:]], device=CPU),
        {"felics.stage.group": 2, "felics.stage.key": 3, "felics.stage.fill": 3,
         "felics.finish.copy_out": 3}),
}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.events())


def _felics(events):
    return [e for e in events if e.name.startswith("felics.")]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_record_their_spans(entry):
    call, want = ENTRIES[entry]
    events = _profiled(call)
    assert Counter(e.name for e in _felics(events)) == want
    # on the CPU no event is waited on, so no wait span
    assert all(e.device_type.name == "CPU" for e in _felics(events))


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_span_encloses_device_work(entry):
    events = _profiled(ENTRIES[entry][0])
    ops = [e for e in events if e.name in DEVICE_OPS]
    assert ops  # the entry point does run such ops, outside the spans
    for s in _felics(events):
        inside = [e.name for e in ops if e.thread == s.thread
                  and s.time_range.start <= e.time_range.start
                  and e.time_range.end <= s.time_range.end]
        assert not inside, (s.name, inside)


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    off = spans.span("felics.stage.group")
    assert off is spans.OFF and spans.span("felics.wait") is off
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:  # taken before the profiler started: records nothing
            np.zeros(8).sum()
        assert spans.span("felics.stage.fill") is not spans.OFF
    assert not _felics(prof.events())
    with spans.span("felics.stage.fill"):
        pass
    assert not torch._C._autograd._profiler_enabled()


def test_every_cpu_group_runs_the_eager_chain():
    eager, replays = dict(tiling.EAGER), dict(graphs.REPLAYS)
    blobs = batch.compress_tiled_batch(_images(), TC, device=CPU)
    assert tiling.EAGER == {"encode": eager["encode"] + 2, "decode": eager["decode"]}
    batch.decompress_tiled_stream([blobs[:2], blobs[2:]], device=CPU)
    assert tiling.EAGER == {"encode": eager["encode"] + 2, "decode": eager["decode"] + 3}
    assert graphs.REPLAYS == replays


def test_a_width_redo_is_counted(monkeypatch):
    """The overflowing-width tiles of the kernel tests outgrow the first
    width hint: finish encodes them again at the exact width, once."""
    from test_torch_flct_cuda import _overflow_inputs

    monkeypatch.setattr(tcd, "_w_hints", {})
    monkeypatch.setattr(tiling, "_cap_hints", {})
    tiles, prior, cfg = _overflow_inputs(CPU)
    plan = tiling.encode_plan([header_for_array(np.zeros((16, 16), np.uint8))], 8, 8, True)
    redos = dict(tiling.REDOS)
    p = tiling.shard_dispatch(tiles, prior, plan)
    assert int(p.bits.max()) > 32 * p.W
    tile_bytes, payload, _ = tiling.shard_finish(p)
    assert len(payload) == int(tile_bytes.sum())
    assert tiling.REDOS == {"width": redos["width"] + 1, "capacity": redos["capacity"]}


def test_a_capacity_redo_is_counted(monkeypatch):
    monkeypatch.setattr(tcd, "_w_hints", {})
    monkeypatch.setattr(tiling, "_cap_hints", {})
    want = batch.compress_tiled_batch(_images(), TC, device=CPU)
    monkeypatch.setattr(tiling, "payload_cap_hint", lambda cfg, nt, t, c: 1)
    redos = dict(tiling.REDOS)
    assert batch.compress_tiled_batch(_images(), TC, device=CPU) == want
    assert tiling.REDOS == {"width": redos["width"], "capacity": redos["capacity"] + 2}


@pytest.mark.parametrize("kind", ["width", "capacity"])
def test_a_redo_records_one_span_closed_before_its_device_work(kind, monkeypatch):
    """A width hint seeded at one word makes two rgb8 noise images of one
    12x12 tile relaunch at the exact width (the least width, 64 words,
    holds 2,048 bits; such a tile takes about 4,000); a capacity hint
    seeded at one word makes them compact again at the exact size. Either
    records one redo span that holds no op of the relaunch or the
    compaction, counts one redo, and leaves the containers the
    reference's. (One small tile: the plain encoder under the profiler
    records every op of its pixel loop.)"""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        from h100_bench.reference import flct_ref
    finally:
        sys.path.remove(root)
    from felics_tpu_torch.config import tiled_config_for_depth
    from felics_tpu_torch.format import PixelDepth

    rng = np.random.default_rng(81)
    imgs = [rng.integers(0, 256, (12, 12, 3), dtype=np.uint8) for _ in range(2)]
    key = (12 * 12, 3, tiled_config_for_depth(PixelDepth.EIGHT).pixel_depth)
    monkeypatch.setattr(tcd, "_w_hints", {key: 1} if kind == "width" else {})
    monkeypatch.setattr(tiling, "_cap_hints", {key: 1} if kind == "capacity" else {})
    redos = dict(tiling.REDOS)
    events = _profiled(lambda: imgs.append(
        batch.compress_tiled_batch(imgs, TileConfig(12, 12), device=CPU)))
    blobs = imgs.pop()
    redo = [e for e in events if e.name.startswith("felics.finish.redo.")]
    assert [e.name for e in redo] == [tiling.REDO_SPANS[kind]] == [f"felics.finish.redo.{kind}"]
    (s,) = redo
    inside = [e.name for e in events if e is not s and e.thread == s.thread
              and s.time_range.start <= e.time_range.start
              and e.time_range.end <= s.time_range.end]
    assert not inside
    assert tiling.REDOS == {k: v + (k == kind) for k, v in redos.items()}
    assert blobs == [flct_ref.encode_image(im, (12, 12), CPU) for im in imgs]


def test_graph_cache_counts_its_evictions():
    from test_torch_onepass import Capture

    cache, cap = graphs.GraphCache(2, 1000), Capture()
    assert cache.evictions == 0
    for k in "abc":
        cache.acquire(k, cap(k))  # first sight: eager
        cache.acquire(k, cap(k)).release()  # captured; "a" goes when "c" comes
    assert [g.key for g in cache.graphs] == ["b", "c"] and cache.evictions == 1
    small = graphs.GraphCache(10, 100)
    for k in "de":
        small.acquire(k, cap(k, 60))
        small.acquire(k, cap(k, 60)).release()  # 60 + 60 > 100: "d" goes
    assert small.evictions == 1 and cache.evictions == 1

"""CUDA graphs of the FLCT device chains: one captured graph per key of a
same-shape group and direction, replayed in place of the eager chain.

Counterpart: the single-dispatch chains of felics_tpu/parallel/tiling.py,
``_fused_encode_chain_images`` (behind ``encode_images_dispatch``) and
``_fused_decode_images_chain`` (behind ``decode_images_dispatch``). XLA
compiles each of those once per static key and runs it as one program. The
port runs the same chain as PyTorch ops, a launch each (88-101 for an
encode batch and 36-49 for a decode batch of the H100 classes), and
captures a key's chain into a
``torch.cuda.CUDAGraph``, so that a batch costs one graph launch and two
copies. A key is a group's plan (``tiling.EncodePlan`` / ``DecodePlan``),
and the body captured is the one the eager path runs (``tiling.run_chain``
of ``encode_chain`` / ``decode_chain``); this module holds the cache.

The first time a key is seen the caller runs its eager chain. That run also
loads the kernels and settles the width and capacity hints the key holds,
which is the warm-up a capture needs. The second time the key is captured
and replayed, and from then on replayed. The key alone decides: a capture
or a replay that fails raises.

A graph owns static buffers: pinned host memory the caller fills, the
device buffer its chain reads, the device buffer the chain writes its
results into (in the graph's private pool), pinned host memory they are
copied back into, and an event. A replay enqueues on the current stream the
upload, the graph and the copy back, then records the event; the uploads
and the copy stay outside the graph, so no pinned block's bookkeeping runs
under capture. A graph is busy from its replay until the caller releases
the result (``Lease.release``): a batch in flight in another stream slot
under the same key gets a graph of its own. Per device the cache keeps at
most ``MAX_GRAPHS`` graphs and ``MAX_MEMORY_SHARE`` of the device's memory
in their pools and input buffers; past either it evicts the least recently
used idle graph. An evicted graph's pool stays with PyTorch's caching
allocator until its cached blocks are released, and a capture cannot
release them itself (while one is under way the allocator releases no
cached block, so an allocation that does not fit fails): the cache counts
the bytes of the graphs it evicted against its bound until it hands them
back (``torch.cuda.empty_cache``), and does so before a capture when the
device runs short.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from felics_tpu_torch.device import pack, unpack
from felics_tpu_torch.ops import tile_codec
from felics_tpu_torch.spans import span

MAX_GRAPHS = 32
MAX_MEMORY_SHARE = 0.25
MAX_SEEN = 1 << 14  # keys remembered as seen once

# Replays and captures per direction ("encode", "decode"); callers reset
# them to 0 to see what a run did.
REPLAYS = {"encode": 0, "decode": 0}
CAPTURES = {"encode": 0, "decode": 0}


class Graph:
    """One captured chain: the graph, its static buffers, the launches of
    the counted kernels it holds, and its device bytes (private pool plus
    input buffer)."""

    def __init__(self, key, graph, host_in, dev_in, dev_out, specs, outputs,
                 launches: Dict[str, int], pool_bytes: int):
        self.key = key
        self.graph = graph
        self.host_in, self.dev_in, self.dev_out = host_in, dev_in, dev_out
        self.host_out = torch.empty(dev_out.numel(), dtype=torch.uint8, pin_memory=True)
        self.specs = specs
        self.outputs = outputs  # named static device tensors of the chain
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.nbytes = pool_bytes + dev_in.numel()
        self.event = torch.cuda.Event()

    def replay(self) -> None:
        """Upload ``host_in``, run the graph, copy its results back to
        ``host_out`` and record the event, all on the current stream; no
        wait on the device."""
        self.dev_in.copy_(self.host_in, non_blocking=True)
        self.graph.replay()
        self.host_out.copy_(self.dev_out, non_blocking=True)
        self.event.record()
        tile_codec.count_launches(**self.launches)
        REPLAYS[self.key[0]] += 1

    def settle(self) -> None:
        """Wait until the last replay is done."""
        with span("felics.wait"):
            self.event.synchronize()


class _Entry:
    """A cached graph and the lease using it (a weak reference: a lease
    dropped without ``release`` leaves the graph to be settled)."""

    def __init__(self, graph):
        self.graph = graph
        self.lease: Optional[weakref.ref] = None

    def busy(self) -> bool:
        return self.lease is not None and self.lease() is not None

    def reclaim(self) -> None:
        """Make an idle graph safe to reuse or free: one whose lease was
        dropped unreleased may still be running."""
        if self.lease is not None:
            self.graph.settle()
            self.lease = None


class Lease:
    """One batch's use of a cached graph, from its replay until
    ``release()``. ``wait()`` returns numpy views of the graph's pinned
    results (the arrays ``device.HostCopy.wait`` returns), valid until
    ``release()``."""

    def __init__(self, entry: _Entry):
        self._entry = entry
        self.graph = entry.graph
        entry.lease = weakref.ref(self)

    def wait(self) -> List[np.ndarray]:
        self.graph.settle()
        return unpack(self.graph.host_out.numpy(), self.graph.specs)

    def release(self) -> None:
        if self._entry is not None:
            self._entry.lease = None
            self._entry = None


class GraphCache:
    """The graphs of one device, least recently used first."""

    def __init__(self, max_graphs: int, max_bytes: int,
                 release: Callable[[], None] = lambda: None,
                 free_bytes: Optional[Callable[[], int]] = None):
        self.max_graphs, self.max_bytes = max_graphs, max_bytes
        self._seen: OrderedDict = OrderedDict()
        self._entries: List[_Entry] = []
        # hands evicted graphs' pools back to the device; the device's free
        # bytes (None: never short)
        self._release, self._free_bytes = release, free_bytes
        self.dropped = 0  # bytes of evicted graphs not handed back yet
        self.largest = 0  # bytes of the largest graph captured
        self.releases = 0
        self.evictions = 0  # graphs evicted

    @property
    def graphs(self) -> List:
        return [e.graph for e in self._entries]

    def acquire(self, key, capture: Callable[[], object]) -> Optional[Lease]:
        """None the first time ``key`` is seen (run the eager chain);
        otherwise a lease on an idle graph of ``key``, captured now (by
        ``capture()``) when the key has none idle."""
        if key not in self._seen and not any(e.graph.key == key for e in self._entries):
            self._seen[key] = None
            if len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
            return None
        self._seen.pop(key, None)
        entry = next((e for e in reversed(self._entries)
                      if e.graph.key == key and not e.busy()), None)
        if entry is None:
            self._make_room()
            entry = _Entry(capture())
            self.largest = max(self.largest, entry.graph.nbytes)
        else:
            self._entries.remove(entry)
            entry.reclaim()
        self._entries.append(entry)
        lease = Lease(entry)
        self.trim()
        return lease

    def trim(self) -> None:
        """Evict least recently used idle graphs past the bounds, then hand
        the evicted graphs' pools back if they and the cached graphs pass
        the byte bound."""
        self._evict()
        if self.dropped and self.dropped + self._bytes() > self.max_bytes:
            self._hand_back()

    def _bytes(self) -> int:
        return sum(e.graph.nbytes for e in self._entries)

    def _evict(self) -> None:
        while len(self._entries) > self.max_graphs or self._bytes() > self.max_bytes:
            victim = next((e for e in self._entries if not e.busy()), None)
            if victim is None:
                return
            victim.reclaim()
            self._entries.remove(victim)
            self.dropped += victim.graph.nbytes
            self.evictions += 1

    def _make_room(self) -> None:
        """Before a capture: hand the evicted graphs' pools back when the
        device's free bytes may not hold twice the largest graph (at least
        an eighth of the bound)."""
        if self._free_bytes is not None and (
                self._free_bytes() < max(self.max_bytes // 8, 2 * self.largest)):
            self._hand_back()

    def _hand_back(self) -> None:
        self._release()
        self.dropped = 0
        self.releases += 1


_caches: Dict[int, GraphCache] = {}
_capture_streams: Dict[int, torch.cuda.Stream] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def cache(device: torch.device) -> GraphCache:
    """The graph cache of a CUDA device, made at first use."""
    index = _index(device)
    if index not in _caches:
        total = torch.cuda.get_device_properties(index).total_memory
        _caches[index] = GraphCache(
            MAX_GRAPHS, int(total * MAX_MEMORY_SHARE), release=torch.cuda.empty_cache,
            free_bytes=lambda: torch.cuda.mem_get_info(index)[0])
    return _caches[index]


def capture(key, device: torch.device, in_bytes: int, body: Callable) -> Graph:
    """Capture ``body(dev_in)`` into a graph on ``device``. ``dev_in`` is the
    graph's static uint8 input of ``in_bytes``; ``body`` returns (the
    tensors to copy back, in ``pack`` order; a dict of named device tensors
    to keep). The capture runs on a side stream after the current stream's
    work and enqueues nothing else; it raises when the body or the capture
    fails."""
    index = _index(device)
    with torch.cuda.device(index):
        host_in = torch.empty(in_bytes, dtype=torch.uint8, pin_memory=True)
        dev_in = torch.empty(in_bytes, dtype=torch.uint8, device=device)
        if index not in _capture_streams:
            _capture_streams[index] = torch.cuda.Stream(index)
        side = _capture_streams[index]
        side.wait_stream(torch.cuda.current_stream())
        reserved = torch.cuda.memory_reserved(index)
        for k in tile_codec.CAPTURED:
            tile_codec.CAPTURED[k] = 0
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                tensors, outputs = body(dev_in)
                dev_out, specs = pack(*tensors)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the body's error is the one to raise
                raise
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        pool = torch.cuda.memory_reserved(index) - reserved
        CAPTURES[key[0]] += 1
        return Graph(key, graph, host_in, dev_in, dev_out, specs, outputs,
                     dict(tile_codec.CAPTURED), pool)

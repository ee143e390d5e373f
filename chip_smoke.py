#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (felics_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --stages   # FLCS stage breakdown and idle share
    python3 chip_smoke.py --flct     # FLCT kernels and main path alone
    python3 chip_smoke.py --stream   # FLCT stream vs one-shot, profiled
    python3 chip_smoke.py --graphs   # phase 11 alone: FLCT graphs vs eager
    python3 chip_smoke.py --k2 TREE  # K2 against TREE's K2, in turns

Phases, one line each, any failure exits non-zero and prints no result:

1. card and toolchain: nvidia-smi name and power limit, torch/CUDA/nvcc
   versions, the nvcc build of felics_tpu_torch/csrc (time, ptxas usage;
   K1 and K2 must have no stack frame and no spills; K5's are reported);
2. both FLCT kernels (K1, K2) against their plain PyTorch versions on the
   card, exact to the word, the bit count and the pixel, on small cases
   (gray8 with zero and real priors, rgb8, rgb16, gray16, odd 13x9 at tile
   5x3, 45x50 at tile 40x24; their k0/prior from K5, equal to its plain
   version), on noise under a k = 0 prior, on the
   relaunch encode_finish makes when a stream outgrows the width hint
   (against a direct launch at that width and the native codec), and K2
   on garbage words;
3. the main path at full size: 12x512^2 gray8, 8x512^2x3 rgb8 and 4x512^2
   gray16 (bench.py's synthetic recipe, seed 0): K1 and K2 against their
   plain versions at each batch's shapes (tile 32) and timed there, on
   gray8 at tile 64 and on the serve stream's chunk (3 gray8 images at
   tile 64: K2's us a step and the share of its steps on the slow path);
   K5 (the k0/prior pass) against its plain version on the same device
   tiles at gray8 t64, rgb8 t32 and gray16 t32 and timed
   there beside its bound, its plain version and its launches a call; then
   each class at tile 32, and gray8 at tiles 64
   and 256, through compress_tiled_batch / decompress_tiled_batch on
   device="cuda": exact round trips, containers byte-identical to the
   native C++ FLCT codec, both kernels launched (counters) and both
   directions' graphs replayed (after GRAPH_WARM warm calls), times from
   CUDA events;
4. corrupt payloads: flipped bytes in gray8 and rgb8 containers, FLCT and
   (after phase 6) FLCS, decode to an image of the right shape or raise
   felics_tpu_torch.errors.DecompressionError, within a fixed time;
5. the FLCS kernels against their plain PyTorch versions on the card,
   exact: per-pixel k of the k scan (K3), and planes, end bit and overrun
   flag of the decoder (K4), on small gray8/gray16/rgb8/rgb16 cases, the
   0/255 halving image, 1x50 and 50x1, K4 against both its plain versions
   (tensor ops, and Python ints lane by lane); both kernels timed beside
   their plain versions on 4 lanes of 64x64 gray8; K4's k-table zeroing
   timed alone (1x2 images); a 2x60000 image whose row ring does not fit
   in shared memory; then at the main path's full shapes (phase 6's
   batches): K3 against its plain version, K4 against the scalar plain
   version on the batch's word rows and on one row with flipped bytes,
   both kernels timed there (CUDA events, >= 5 warm launches);
6. the FLCS main path at full size through felics_tpu_torch.api on
   device="cuda": 4x512^2 gray8, 2x512^2x3 rgb8 and 2x512^2 gray16 through
   compress_images_bytes / decompress_images_bytes: containers
   byte-identical to the native C++ codec, native containers decoding
   exactly, exact round trips, batched bytes equal to the per-image call,
   one FLCT image routed through the API, K3 and K4 launched (counters),
   times from CUDA events beside the native codec on one host core;
7. the FLCT stream pair at full size: phase 3's batches in bench.py's
   stream_bench chunks (gray8 in chunks of 3, rgb8 and gray16 in chunks
   of 2; tile 32, depth 2) through compress_tiled_stream /
   decompress_tiled_stream: containers byte-identical to
   compress_tiled_batch and to the native codec, exact round trips, K1
   and K2 launched (counters, read right after each stream call); Mpx/s
   (best of 5 warm runs, CUDA events) of the stream at depth 2 and 1, of
   the same chunks through back-to-back batched calls, and of the whole
   class in one batched call, beside the native codec on one host core;
   then
   on_error="isolate" in the batch and the stream call on batches with a
   truncated member, a zeroed tile-width field and flipped payload bytes;
   then the long row: one 4096x4096 tile of uniform gray16 noise, whose
   stream passes 2^31 bits, encoded on the card, byte-identical to the
   native codec, decoded exactly through K2's 64-bit-position
   instantiation (its own counter);
8. the sharded paths and the CLIs: K1 and K2 against their plain versions
   at the shapes the sharded paths give them on one 4096^2 gray8 image at
   tile 64 (its 4096 tiles as one shard and as two of 2048), exact; the
   mesh (make_tile_mesh(), the card, and (cuda:0, cuda:0)) on phase 3's
   classes image by image at tile 32 and on that image, through
   encode_tiled_sharded / decode_tiled_sharded; two gloo ranks sharing cuda:0 (worker processes
   of this script, ``--worker``) through encode_corpus_multihost on the
   gray8 class and encode_tiled_multihost / decode_tiled_multihost on the
   4096^2 image, then one NCCL rank at world size 1 on one 512^2 image:
   containers byte-identical to the one-device calls and the native
   codec, exact decodes, K1 and K2 launched in every shard and rank, ms
   beside the one-device calls (the gloo decode also split into its
   gather and its assembly); then cfelics / dfelics (FLCS, and FLCT at
   tile 64) on 512^2 gray8 and rgb16 TIFFs, vfelics --export and bfelics
   (.fel and .qoi rows) in this process on --device cuda, against the
   native codec, K1-K4 launched;
9. the host backends and the port's scalar oracle (core/oracle.py) as an
   independent check of the kernels: felics_tpu_torch.api under
   backend="device", "oracle" and "native" on gray8 128^2, rgb8 96^2x3,
   gray16 128^2 and rgb16 64^2x3 (bytes identical, every container exact
   under every backend, Mpx/s of each, best of 3 calls on the host
   clock); 8 tile streams
   of phase 3's first gray8 and rgb8 images written through K1 at tile 32,
   decoded by the oracle in bucketed-k mode into the image's tiles and
   encoded back to the same bits, K2's planes of those streams equal to
   the oracle's; K4's planes and end bit of a 128^2 gray8 FLCS payload
   equal to the oracle's; cfelics --backend oracle|native writing the
   .fel --backend device writes, dfelics under every backend writing the
   image; K1-K4 launched;
10. the edges: every shape of the 0..20 x 0..20 grid (uniform noise,
   seeded) for gray8, gray16, rgb8 and rgb16, one batch a class, FLCS
   through api.compress_images_bytes / decompress_images_bytes and FLCT
   through compress_tiled_batch / decompress_tiled_batch at tiles 2x2,
   4x3 and 64x64, on device="cuda": containers byte-identical to the
   native codec (native.compress, native.compress_tiled; for the
   header-only FLCT container of a zero-area image native clamps the tile
   fields to the image where felics_tpu writes max(2, tile), and the
   check says so), exact decodes, K1-K4 launched (counters), zero-area
   images alone launching none; then K1 and K2 against their plain
   versions (on the CPU, on the same inputs) on each class's batch at
   tile 2x2 and on its 1xN and Nx1 rows at 4x3 and 64x64, and K3 and K4
   against kscan_ref and decode_scan_scalar on those rows, exact to the
   word, bit count, k, plane and end bit;
11. the CUDA graphs of the same-shape FLCT chains (parallel/graphs.py):
   gray8 12x512^2 at tiles 32 and 64, rgb8 8x512^2x3 and gray16 4x512^2
   through the batched pair and the stream pair on the graph path
   (containers byte-identical to the eager chain's and the native codec's,
   exact decodes, graphs replayed, K1 and K2 counted inside the replays),
   then timed beside the same calls on the eager chains in one call
   (one-shot, and phase 7's stream at depth 2 and 1 and back-to-back
   batched calls; best of 3 after warm calls, in turns eager, graph,
   graph, eager), with the host's launch and copy calls and the device's
   idle share of one profiled one-shot call a direction and mode, and the
   graphs' pool bytes.

No module of JAX or of the JAX package felics_tpu is imported; the native
codec is reached through felics_tpu_torch.native (native/build.py builds
it). Each kernel's entry in the kernels line carries its time and its
plain version's at the main path's shape, its bound (bytes at 3.35 TB/s
against operations), its launches on the main path and per call, its
launches on phase 8's sharded paths and CLIs and in phases 9 and 10, and
the graph replays and captures of its direction on the main path and in
phase 11 (with phase 11's launches).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TILE = 32
CORRUPT_SECONDS = 60.0  # limit for one corrupt-container decode
# Phase 7: bench.py's stream_bench chunking and depth, and the side of the
# long-row tile. Uniform gray16 noise in one tile costs more bits a pixel
# the longer the tile (the k-table's uint32 sums wrap, in the format and in
# the native codec alike): ~259 bits a pixel at 4096x4096, a stream of
# ~4.3e9 bits, twice 2^31.
STREAM_CHUNKS = {"gray8": 3, "rgb8": 2, "gray16": 2}
STREAM_DEPTH = 2
LONG_SIDE = 4096
# Phase 8: the one large image the sharded paths take (4096 tiles of 64x64)
# and the limit on each worker process of the process groups.
BIG_SIDE = 4096
BIG_TILE = 64
WORKER_SECONDS = 240
# Phase 10: every shape 0..20 x 0..20, and FLCT at the smallest tile, an
# odd one and one wider than every image of the grid.
EDGE_SIDES = range(21)
EDGE_TILES = ((2, 2), (4, 3), (64, 64))
# Phase 11 (and the warm-up of timed FLCT calls): a same-shape group's key
# runs eagerly at its first sighting and is captured at its second; a hint
# that moves after the first call makes a new key. Three calls of a batch
# leave it replaying its graph. The classes and tiles phase 11 measures.
GRAPH_WARM = 3
GRAPH_RUNS = (("gray8", 32), ("gray8", 64), ("rgb8", 32), ("gray16", 32))
# Phase 11's check of the cache's bound: gray8 batches of 1..GRAPH_CHURN
# images (pools of ~43 MB an image) under a bound cut to 1 GiB.
GRAPH_CHURN = 16
GRAPH_CHURN_BYTES = 1 << 30
# Phase 11's profiled windows: calls in one window, and windows with CPU
# and CUDA activities before a last one with CUDA alone (profiled_calls).
PROFILE_CALLS = 3
PROFILE_TRIES = 3
# H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM3 bytes a
# second, and float32 operations a second outside the tensor cores, the
# nearest entry to the kernels' 32-bit integer operations.
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
# K2's shape in the serve stream: a chunk of 3 gray8 512^2 images at tile
# 64 (192 tiles). --k2 times K2 there and at the batch shapes, in turns
# with another tree's K2 (K2_ROUNDS rounds of other, this, this, other).
K2_CHUNK = 3
K2_ROUNDS = 3
# Integer operations counted per pixel step of K1, K2 and K4 (neighbours,
# context, marker, code, table), and per k-table entry of a K3 update.
OPS_PER_STEP = 10
OPS_PER_K_ENTRY = 4


def fail(msg: str) -> None:
    """Report a failed check on both outputs (a caller that keeps only the
    end of one still sees why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def synth(shape, dtype, n, step, np):
    """bench.py::_synth: double cumulative sum of a seeded random walk."""
    rng = np.random.default_rng(0)
    hi = np.iinfo(dtype).max
    return [
        np.clip(
            np.cumsum(np.cumsum(rng.integers(-step, step + 1, shape), 0), 1)
            + hi // 2, 0, hi,
        ).astype(dtype)
        for _ in range(n)
    ]


def small_image(shape, depth_max, seed, smooth, np):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth_max == 255 else np.uint16
    if smooth:
        base = rng.integers(-3, 4, shape).cumsum(axis=1) + depth_max // 2
        return np.clip(base, 0, depth_max).astype(dt)
    return rng.integers(0, depth_max + 1, shape).astype(dt)


def checker_noise(h, w, seed, np):
    rng = np.random.default_rng(seed)
    checker = (np.arange(h)[:, None] + np.arange(w)[None, :]) % 2 == 1
    bright, dark = rng.integers(240, 256, (h, w)), rng.integers(0, 16, (h, w))
    return np.where(checker, bright, dark).astype(np.uint8)


def bound(nbytes: int, ops: int):
    """(least ms the card could take, what bounds it): each input byte read
    once and each output byte written once at HBM_BYTES_S, against the
    operations at SCALAR_OPS_S."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / SCALAR_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms of fn() over `reps` runs, from CUDA events (one warm run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flct_classes(np):
    """The FLCT main path's batches: bench.py's recipes, seed 0."""
    return [
        ("gray8", synth((512, 512), np.uint8, 12, 6, np)),
        ("rgb8", synth((512, 512, 3), np.uint8, 8, 6, np)),
        ("gray16", synth((512, 512), np.uint16, 4, 800, np)),
    ]


def flct_kernel_inputs(torch, dev, images, tile):
    """K1's and K2's inputs at one batch's shape, as the main path makes
    them: tiles, per-tile prior, and the words and bits the encode chain
    packs its containers from (encode_dispatch, then encode_finish)."""
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.parallel import tiling

    headers = [header_for_array(im) for im in images]
    p = tiling.encode_dispatch(images, headers, tile, tile, True, dev)
    tiling.encode_finish(p)
    return {"tiles": p.tiles, "prior": p.prior, "cfg": p.plan.cfg, "tile": tile,
            "words": p.words, "bits": p.bits}


def flct_kernel_times(torch, ks, reps: int = 10) -> dict:
    """K1 and K2 at one batch's shape: mean ms of `reps` warm calls of each
    wrapper (CUDA events) and of the kernel alone (profiler), K2's us a
    pixel step of one tile's chain, its tiles a block and the share of its
    steps that took the slow path (codes longer than its 32-bit window),
    and each kernel's bound (in: tiles, per-tile priors, the words the
    streams use; out: the words, bit counts, planes)."""
    from felics_tpu_torch.ops import tile_codec as tcd

    tiles, prior, cfg, tile = ks["tiles"], ks["prior"], ks["cfg"], ks["tile"]
    words, bits = ks["words"], ks["bits"]
    nt, c, t = tiles.shape
    W = words.shape[1]
    def encode():
        return tcd.encode_tiles(tiles, cfg, tile, tile, W, prior)

    def decode():
        return tcd.decode_tiles(words, cfg, tile, tile, c, prior)

    enc, dec = cuda_ms(torch, encode, reps), cuda_ms(torch, decode, reps)
    slow = torch.zeros(1, dtype=torch.int64, device=words.device)
    tcd.decode_tiles(words, cfg, tile, tile, c, prior, slow_steps=slow)
    used = int(((bits + 31) // 32).sum()) * 4
    ops = OPS_PER_STEP * tiles.numel()
    return {"tiles": nt, "planes": c, "tile": tile, "W": W, "encode_ms": enc,
            "decode_ms": dec, "decode_us_per_step": dec * 1e3 / (c * (t - 2)),
            "decode_tpb": tcd.decode_tiles_per_block(nt),
            "decode_slow_share": int(slow) / (nt * c * (t - 2)),
            # the kernel alone, without the wrapper's checks, allocations
            # and (encode) zeroing of the word rows
            "encode_kernel_ms": device_ms(torch, encode, "flct_encode_kernel", reps),
            "decode_kernel_ms": device_ms(torch, decode, "flct_decode_kernel", reps),
            "encode_bound": bound(tiles.numel() * 4 + prior.numel() * 4 + used + nt * 8, ops),
            "decode_bound": bound(used + prior.numel() * 4 + tiles.numel() * 4, ops)}


# K5's main-path shapes: (class, batch, tile), as the ingest cells and
# phase 3 run them.
K5_SHAPES = (("gray8", 64), ("rgb8", 32), ("gray16", 32))


def k0_prior_times(np, torch, dev, images, tile, reps: int = 20) -> dict:
    """K5 (tiling.k0_prior on the card) at one batch's shape, as the encode
    chain tiles it: its outputs against the plain version run on the same
    device tiles (exact, or fail), the wrapper's mean ms over `reps` warm
    calls (CUDA events), its two kernels alone (profiler), the plain
    version's ms on the card, launches a call, and the bound (the tiles
    read once and the priors written once at HBM_BYTES_S)."""
    from felics_tpu_torch.config import tiled_config_for_depth
    from felics_tpu_torch.device import upload_image
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import tiling

    cfg = tiled_config_for_depth(header_for_array(images[0]).pixel_depth)
    tiles = tiling.image_tiles(upload_image(np.stack(images), dev), tile, tile)
    nt, c, t = tiles.shape
    counts = [nt // len(images)] * len(images)

    def kernel():
        return tiling.k0_prior(tiles, counts, tile, tile, cfg)

    def plain():
        return tiling.k0_prior_ref(tiles, counts, tile, tile, cfg)

    before = tcd.PRIOR_LAUNCHES
    k0, prior = kernel()
    torch.cuda.synchronize()
    per_call = tcd.PRIOR_LAUNCHES - before
    want_k0, want_prior = plain()
    err = max(int((k0.long() - want_k0.long()).abs().max()),
              int((prior.long() - want_prior.long()).abs().max()))
    if err or per_call != 2:
        fail(f"K5 at {len(images)}x{list(images[0].shape)} t{tile}: err {err} against "
             f"the plain version, {per_call} launches a call")
    return {"images": len(images), "shape": list(images[0].shape), "tile": tile,
            "tiles": nt, "planes": c, "K": cfg.num_k, "err": err,
            "launches_per_call": per_call, "ms": cuda_ms(torch, kernel, reps),
            "kernel_ms": device_ms(torch, kernel, "flct_k0_", reps),
            "plain_ms": cuda_ms(torch, plain, 3),
            "bound": bound(tiles.numel() * 4 + prior.numel() * 4 + k0.numel() * 4,
                           OPS_PER_STEP * tiles.numel())}


def flct_main_path(np, torch, dev, images, tile, reps: int = 5):
    """One batch through compress_tiled_batch / decompress_tiled_batch on the
    card: exact round trips and containers byte-identical to the native C++
    codec, or fail; ms from CUDA events (mean and best of `reps` calls after
    GRAPH_WARM warm ones, which capture the batch's graphs). Returns the
    containers and a row of numbers."""
    from felics_tpu_torch import compress_tiled_batch, decompress_tiled_batch, native
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.format import header_for_array

    tc = TileConfig(tile, tile)
    for _ in range(GRAPH_WARM):  # warm: a same-shape group's graph is captured
        blobs = compress_tiled_batch(images, tc, device=dev)
        decompress_tiled_batch(blobs, device=dev)
    enc = call_ms(torch, lambda: compress_tiled_batch(images, tc, device=dev), reps)
    dec = call_ms(torch, lambda: decompress_tiled_batch(blobs, device=dev), reps)
    (enc_ms, enc_best), (dec_ms, dec_best) = enc, dec
    outs = decompress_tiled_batch(blobs, device=dev)
    for i, (im, out) in enumerate(zip(images, outs)):
        if out.dtype != im.dtype or not np.array_equal(out, im):
            fail(f"image {i} of {im.shape} at tile {tile}: round trip is not exact")
        if blobs[i] != native.compress_tiled(im, header_for_array(im), tile, tile):
            fail(f"image {i} of {im.shape} at tile {tile}: container differs from "
                 "the native codec")
    px = sum(im.shape[0] * im.shape[1] for im in images)
    raw = sum(im.nbytes for im in images)
    return blobs, {
        "images": len(images), "shape": list(images[0].shape), "tile": tile,
        "encode_ms": enc_ms, "decode_ms": dec_ms,
        "encode_mpx_s": px / enc_ms / 1e3, "decode_mpx_s": px / dec_ms / 1e3,
        "combined_mpx_s": 2 * px / (enc_ms + dec_ms) / 1e3,
        "encode_best_ms": enc_best, "decode_best_ms": dec_best,
        "combined_best_mpx_s": 2 * px / (enc_best + dec_best) / 1e3,
        "ratio": raw / sum(len(b) for b in blobs),
        "exact_round_trip": True, "native_bytes_identical": True,
    }


def call_ms(torch, fn, reps: int):
    """(mean, best) ms of `reps` calls of fn() after a warm one, each
    between two CUDA events on the current stream. The FLCT calls return
    with their results on the host, whatever streams they ran on, so this
    is the call's whole time."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / reps, min(times)


def stream_calls(tc, dev, images, chunks, blobs, streamed) -> dict:
    """Phase 7's timed calls of one class, each way; each returns with its
    results on the host. The stream at STREAM_DEPTH and at depth 1 (same
    machinery, nothing in flight to overlap), the same chunks through
    back-to-back batched calls (no stream machinery), and the whole class
    in one batched call."""
    from felics_tpu_torch import (
        compress_tiled_batch, compress_tiled_stream, decompress_tiled_batch,
        decompress_tiled_stream,
    )

    return {
        "stream_encode": lambda: compress_tiled_stream(
            iter(chunks), tc, depth=STREAM_DEPTH, device=dev),
        "stream_decode": lambda: decompress_tiled_stream(
            iter(streamed), depth=STREAM_DEPTH, device=dev),
        "stream_d1_encode": lambda: compress_tiled_stream(iter(chunks), tc, depth=1, device=dev),
        "stream_d1_decode": lambda: decompress_tiled_stream(iter(streamed), depth=1, device=dev),
        "batched_encode": lambda: [compress_tiled_batch(c, tc, device=dev) for c in chunks],
        "batched_decode": lambda: [decompress_tiled_batch(b, device=dev) for b in streamed],
        "one_shot_encode": lambda: compress_tiled_batch(images, tc, device=dev),
        "one_shot_decode": lambda: decompress_tiled_batch(blobs, device=dev),
    }


def flct_stream(np, torch, dev, card, classes, blobs_by_class) -> dict:
    """Phase 7, the stream pair: each class in bench.py's chunks through
    compress_tiled_stream / decompress_tiled_stream on the card, checked
    batch by batch against compress_tiled_batch, the native codec and the
    images, then timed beside its controls (the stream at depth 1, the same
    chunks through back-to-back batched calls, the whole class in one
    batched call) and the native codec on one host core. Returns the
    kernel launches of the stream calls alone: each counter is set to 0
    just before its direction's stream calls and read just after them."""
    from felics_tpu_torch import (
        compress_tiled_batch, compress_tiled_stream, decompress_tiled_stream, native,
    )
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd

    tc = TileConfig(TILE, TILE)
    chunked = {name: [images[i : i + STREAM_CHUNKS[name]]
                      for i in range(0, len(images), STREAM_CHUNKS[name])]
               for name, images in classes}
    tcd.ENCODE_LAUNCHES = 0
    streamed = {name: compress_tiled_stream(iter(chunks), tc, depth=STREAM_DEPTH, device=dev)
                for name, chunks in chunked.items()}
    launches = {"encode": tcd.ENCODE_LAUNCHES}
    tcd.DECODE_LAUNCHES = 0
    restored = {name: decompress_tiled_stream(iter(streamed[name]), depth=STREAM_DEPTH,
                                              device=dev)
                for name in chunked}
    launches["decode"] = tcd.DECODE_LAUNCHES
    if not (launches["encode"] and launches["decode"]):
        fail(f"the stream did not launch both kernels: {launches}")
    for name, chunks in chunked.items():
        for k, (chunk, got, back) in enumerate(zip(chunks, streamed[name], restored[name])):
            if got != compress_tiled_batch(chunk, tc, device=dev):
                fail(f"stream {name} batch {k}: bytes differ from compress_tiled_batch")
            for im, blob, out in zip(chunk, got, back):
                if blob != native.compress_tiled(im, header_for_array(im), TILE, TILE):
                    fail(f"stream {name} batch {k}: a container differs from the native codec")
                if out.dtype != im.dtype or not np.array_equal(out, im):
                    fail(f"stream {name} batch {k}: round trip is not exact")
        if [b for batch in streamed[name] for b in batch] != blobs_by_class[name][1]:
            fail(f"stream {name}: containers differ from phase 3's batched call")

    for name, images in classes:
        chunks, blobs = chunked[name], blobs_by_class[name][1]
        px = sum(im.shape[0] * im.shape[1] for im in images)
        ms = {k: call_ms(torch, fn, 5)[1]
              for k, fn in stream_calls(tc, dev, images, chunks, blobs, streamed[name]).items()}
        t0 = time.perf_counter()
        natives = [native.compress_tiled(im, header_for_array(im), TILE, TILE, 1)
                   for im in images]
        t1 = time.perf_counter()
        native_outs = [native.decompress_tiled(b, 1) for b in natives]
        t2 = time.perf_counter()
        if any(not np.array_equal(o, im) for o, im in zip(native_outs, images)):
            fail(f"stream {name}: the native FLCT decoder did not give the images back")
        mpx = {k: px / v / 1e3 for k, v in ms.items()}
        combined = {run: 2 * px / (ms[f"{run}_encode"] + ms[f"{run}_decode"]) / 1e3
                    for run in ("stream", "stream_d1", "batched", "one_shot")}
        say("7 stream", nvidia_smi=card, cls=name, images=len(images),
            chunk=STREAM_CHUNKS[name], batches=len(chunks), depth=STREAM_DEPTH, tile=TILE,
            **{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_mpx_s": v for k, v in mpx.items()},
            **{f"{run}_mpx_s": v for run, v in combined.items()},
            stream_over_one_shot=combined["stream"] / combined["one_shot"],
            stream_over_batched=combined["stream"] / combined["batched"],
            stream_over_depth1=combined["stream"] / combined["stream_d1"],
            batched_over_one_shot=combined["batched"] / combined["one_shot"],
            native_1core_encode_mpx_s=px / (t1 - t0) / 1e6,
            native_1core_decode_mpx_s=px / (t2 - t1) / 1e6,
            bytes_equal_batch=True, bytes_equal_native=True, exact_round_trip=True)
    return launches


def flct_isolate(np, dev, images, blobs) -> None:
    """Phase 7, on_error="isolate": three gray8 batches, one with a
    truncated member, one with a zeroed tile-width header field, one with
    the first tile's stream bytes flipped, through decompress_tiled_batch
    and decompress_tiled_stream. Good members must come back exact, bad
    ones as DecompressionErrors; on_error="raise" must raise."""
    from felics_tpu_torch import decompress_tiled_batch, decompress_tiled_stream, errors
    from felics_tpu_torch.parallel import flct

    hd = flct.read_tiled_header(blobs[7])
    flipped = bytearray(blobs[7])
    for i in range(hd.payload_off, hd.payload_off + int(hd.tile_lengths[0])):
        flipped[i] ^= 0xFF
    batches = [
        ([blobs[0], blobs[1][:-5], blobs[2]], 1),
        ([blobs[3][:14] + b"\x00\x00" + blobs[3][16:], blobs[4], blobs[5]], 0),
        ([blobs[6], bytes(flipped), blobs[8]], 1),
    ]
    first = [0, 3, 6]
    by_batch = [decompress_tiled_batch(b, device=dev, on_error="isolate") for b, _ in batches]
    by_stream = decompress_tiled_stream(iter([b for b, _ in batches]), depth=STREAM_DEPTH,
                                        on_error="isolate", device=dev)
    seen = []
    for (batch, bad), i0, outs_b, outs_s in zip(batches, first, by_batch, by_stream):
        for j, (ob, os_) in enumerate(zip(outs_b, outs_s)):
            if j == bad:
                if not (isinstance(ob, errors.DecompressionError)
                        and type(ob) is type(os_)):
                    fail(f"isolate: bad member {i0 + j} gave {ob!r} / {os_!r}")
                seen.append(type(ob).__name__)
            elif not all(isinstance(o, np.ndarray) and np.array_equal(o, images[i0 + j])
                         for o in (ob, os_)):
                fail(f"isolate: good member {i0 + j} is not exact")
        try:
            decompress_tiled_batch(batch, device=dev)
            fail(f"on_error='raise' did not raise on batch {i0 // 3}")
        except errors.DecompressionError:
            pass
    say("7 isolate", batches=len(batches), bad_members=seen, good_members_exact=True)


def flct_long_row(np, torch, dev, card) -> dict:
    """Phase 7, the long row: one LONG_SIDE^2 tile of uniform gray16 noise
    whose stream passes 2^31 bits, encoded on the card, held to the native
    codec, decoded exactly through K2's 64-bit-position instantiation. Host
    clock around each call (each ends with its result on the host)."""
    from felics_tpu_torch import compress_tiled_bytes, decompress_tiled_bytes, native
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import flct

    side = LONG_SIDE
    img = np.random.default_rng(3).integers(0, 1 << 16, (side, side), dtype=np.uint16)
    tc = TileConfig(side, side)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = tcd.DECODE_WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    blob, k1_ms = profiled(torch, lambda: compress_tiled_bytes(img, tc, device=dev),
                           "flct_encode_kernel")
    t1 = time.perf_counter()
    hd = flct.read_tiled_header(blob)
    n_bytes = int(hd.tile_lengths[0])
    # The tile's byte length is K1's bit count rounded up to bytes.
    min_bits = 8 * (n_bytes - 1) + 1
    if hd.n_tiles != 1 or min_bits <= 1 << 31:
        fail(f"long row: {hd.n_tiles} tiles, a stream of at least {min_bits} bits "
             "does not pass 2^31")
    nat = native.compress_tiled(img, header_for_array(img), side, side, 1)
    t2 = time.perf_counter()
    if blob != nat:
        fail("long row: container differs from the native codec")
    encode_launches = tcd.ENCODE_LAUNCHES
    t3 = time.perf_counter()
    out, k2_ms = profiled(torch, lambda: decompress_tiled_bytes(blob, device=dev),
                          "flct_decode_kernel")
    t4 = time.perf_counter()
    wide = tcd.DECODE_WIDE_LAUNCHES
    if out.dtype != img.dtype or not np.array_equal(out, img):
        fail("long row: round trip is not exact")
    if not (wide and wide == tcd.DECODE_LAUNCHES):
        fail(f"long row: K2's 64-bit instantiation did not run ({wide} of "
             f"{tcd.DECODE_LAUNCHES} launches)")
    row = {"shape": [side, side], "tile": side, "stream_bytes": n_bytes,
           "stream_bits_at_least": min_bits, "over_2_31": min_bits / (1 << 31),
           "bits_per_pixel": 8 * n_bytes / side**2, "encode_s": t1 - t0,
           "k1_kernel_ms": k1_ms, "native_1core_encode_s": t2 - t1,
           "decode_s": t4 - t3, "k2_kernel_ms": k2_ms,
           "k2_us_per_step": k2_ms and k2_ms * 1e3 / (side * side - 2),
           "encode_launches": encode_launches, "decode_wide_launches": wide,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "native_bytes_identical": True, "exact_round_trip": True}
    say("7 long row", nvidia_smi=card, **row)
    return row


def big_image(np):
    """Phase 8's one large image: a 4096x4096 gray8 _synth image, seed 0
    (4096 tiles at tile 64)."""
    return synth((BIG_SIDE, BIG_SIDE), np.uint8, 1, 6, np)[0]


def container_rows(hd, lens, streams, dev):
    """K2's (n, wd) word rows of tile streams of ``lens`` bytes and the
    prior of the container ``hd``, on ``dev``: staged in the decode
    chain's input layout (fill_containers), then its views and word_rows."""
    from felics_tpu_torch.device import upload_filled
    from felics_tpu_torch.parallel import tiling

    plan = tiling.decode_plan([hd], lens)
    buf = upload_filled(plan.in_bytes(), dev, lambda host: tiling.fill_containers(
        host, plan, [hd], lens, streams))
    lens_t, priors, payload = tiling.container_views(buf, plan)
    return tiling.word_rows(payload, lens_t, plan.wd), priors[0]


def shard_kernels(torch, dev, big, big_single) -> dict:
    """K1 and K2 against their plain versions at the shapes the sharded
    paths give them on the 4096^2 image: its 4096 tiles as one shard and
    as two shards of 2048 (K2 puts 8 and 4 tiles in a block). K1 runs as a
    shard does (encode_images, then shard_dispatch and shard_finish), K2 on
    the container's word rows, staged as the decode chain stages them
    (container_rows) and cut as decode_shards cuts them; one plain run of each over all
    the tiles, and every shard's output must equal its rows exactly.
    Returns both errors and the plain runs' seconds."""
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import flct, tiling

    from felics_tpu_torch.device import upload_filled

    t = BIG_TILE
    plan = tiling.encode_plan([header_for_array(big)], t, t, True)
    tiles, _, prior = tiling.encode_images(upload_filled(
        plan.in_bytes(), dev, lambda host: tiling.fill_images(host, plan, [big])), plan)
    cfg = plan.cfg
    nt = tiles.shape[0]
    shards = [(0, nt), (0, nt // 2), (nt // 2, nt)]
    done = []
    for lo, hi in shards:
        p = tiling.shard_dispatch(tiles[lo:hi], prior[lo:hi], plan)
        tiling.shard_finish(p)
        done.append(p)
    t0 = time.perf_counter()
    wr, br = tcd.encode_tiles_ref(tiles, cfg, t, t, max(p.W for p in done), prior)
    torch.cuda.synchronize()
    enc_plain_s = time.perf_counter() - t0
    enc_err = max(max(int((p.words.long() - wr[lo:hi, : p.W].long()).abs().max()),
                      int((p.bits - br[lo:hi]).abs().max()),
                      int(wr[lo:hi, p.W :].count_nonzero()))
                  for p, (lo, hi) in zip(done, shards))
    hd = flct.read_tiled_header(big_single)
    rows, prior_t = container_rows(hd, hd.tile_lengths, [tiling.payload_of(big_single, hd)],
                                   dev)
    t0 = time.perf_counter()
    dr = tcd.decode_tiles_ref(rows, cfg, t, t, 1, prior_t)
    torch.cuda.synchronize()
    dec_plain_s = time.perf_counter() - t0
    dec_err = max(int((tcd.decode_tiles(rows[lo:hi], cfg, t, t, 1, prior_t).long()
                       - dr[lo:hi].long()).abs().max()) for lo, hi in shards)
    rt_err = int((dr.long() - tiles.long()).abs().max())
    if enc_err or dec_err or rt_err:
        fail(f"4096^2 shards: kernel vs plain enc_err={enc_err} dec_err={dec_err} "
             f"round_trip_err={rt_err}")
    row = {"shards": [hi - lo for lo, hi in shards], "W": [p.W for p in done],
           "decode_tiles_per_block": [tcd.decode_tiles_per_block(hi - lo)
                                      for lo, hi in shards],
           "enc_err": enc_err, "dec_err": dec_err,
           "encode_plain_s": enc_plain_s, "decode_plain_s": dec_plain_s}
    say("8 shard kernels", **row)
    return row


def sharded_mesh(np, torch, dev, card, classes, blobs_by_class) -> dict:
    """Phase 8, the mesh: on make_tile_mesh() (the card) and on (cuda:0,
    cuda:0), phase 3's classes image by image at tile 32 and the 4096^2
    image at tile 64 through encode_tiled_sharded / decode_tiled_sharded:
    containers byte-identical to the one-device compress_tiled_bytes and to
    the native codec, exact decodes, K1 and K2 launched at least once a
    shard a call; ms (CUDA events, mean of 3 warm calls) beside the
    one-device calls, after shard_kernels. Returns the K1/K2 launches of
    the checked calls, the kernels' errors against their plain versions
    and the 4096^2 image's one-device container."""
    from felics_tpu_torch import compress_tiled_bytes, decompress_tiled_bytes, native
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import mesh

    big = big_image(np)
    big_tc = TileConfig(BIG_TILE, BIG_TILE)
    big_single = compress_tiled_bytes(big, big_tc, device=dev)
    if big_single != native.compress_tiled(big, header_for_array(big), BIG_TILE, BIG_TILE):
        fail("4096^2 gray8: the one-device container differs from the native codec")
    kernels = shard_kernels(torch, dev, big, big_single)
    runs = [(name, images, TileConfig(TILE, TILE), blobs_by_class[name][1])
            for name, images in classes]
    runs.append(("gray8 4096^2", [big], big_tc, [big_single]))
    launches = {"encode": 0, "decode": 0}
    for label, m in (("card", mesh.make_tile_mesh()),
                     ("cuda:0 x2", mesh.make_tile_mesh(["cuda:0", "cuda:0"]))):
        for name, images, tc, singles in runs:
            enc_n = dec_n = 0
            for i, (im, single) in enumerate(zip(images, singles)):
                tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = 0
                data = mesh.encode_tiled_sharded(im, m, tc)
                out = mesh.decode_tiled_sharded(data, m)
                enc_n, dec_n = enc_n + tcd.ENCODE_LAUNCHES, dec_n + tcd.DECODE_LAUNCHES
                if data != single or data != compress_tiled_bytes(im, tc, device=dev):
                    fail(f"mesh {label} {name} image {i}: container differs from the "
                         "one-device compress_tiled_bytes and the native codec")
                if out.dtype != im.dtype or not np.array_equal(out, im):
                    fail(f"mesh {label} {name} image {i}: decode is not exact")
            if min(enc_n, dec_n) < len(m) * len(images):
                fail(f"mesh {label} {name}: K1/K2 launched {enc_n}/{dec_n} times for "
                     f"{len(images)} images over {len(m)} shards")
            launches["encode"] += enc_n
            launches["decode"] += dec_n
            ms = {
                "sharded_encode": lambda: [mesh.encode_tiled_sharded(im, m, tc) for im in images],
                "single_encode": lambda: [compress_tiled_bytes(im, tc, device=dev)
                                          for im in images],
                "sharded_decode": lambda: [mesh.decode_tiled_sharded(b, m) for b in singles],
                "single_decode": lambda: [decompress_tiled_bytes(b, device=dev)
                                          for b in singles],
            }
            ms = {k: call_ms(torch, fn, 3)[0] for k, fn in ms.items()}
            px = sum(im.shape[0] * im.shape[1] for im in images)
            say("8 mesh", nvidia_smi=card, mesh=label, shards=len(m), cls=name,
                images=len(images), tile=tc.tile_h, k1_launches=enc_n, k2_launches=dec_n,
                **{f"{k}_ms": v for k, v in ms.items()},
                sharded_combined_mpx_s=2 * px / (ms["sharded_encode"] + ms["sharded_decode"]) / 1e3,
                single_combined_mpx_s=2 * px / (ms["single_encode"] + ms["single_decode"]) / 1e3,
                bytes_equal_single_and_native=True, exact_round_trip=True)
    return {"launches": launches, "big_single": big_single,
            "errs": {"encode": kernels["enc_err"], "decode": kernels["dec_err"]}}


def group_worker(backend: str, address: str, world: int, rank: int, out_dir: str) -> None:
    """One rank of phase 8's process groups (``--worker``): joins the group,
    runs the sharded calls on cuda:0 (gloo: the gray8 class through
    encode_corpus_multihost, then the 4096^2 image through
    encode_tiled_multihost and decode_tiled_multihost; NCCL: one 512^2
    image both ways), checks its decodes, writes its containers to
    ``out_dir`` and prints one JSON line: launches and ms (CUDA events,
    mean of 3 warm calls) of each call, and under gloo the decode's gather
    and assembly timed alone."""
    np, torch = need_gpu_and_repo()
    import torch.distributed as dist

    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.device import HostCopy
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import flct, mesh, multihost, tiling

    dev = "cuda:0"
    multihost.init_process(address, world, rank, backend=backend)
    gray8 = flct_classes(np)[0][1]
    if backend == "gloo":
        big = big_image(np)
        calls = [
            ("corpus", lambda: multihost.encode_corpus_multihost(
                gray8, TileConfig(TILE, TILE), device=dev)),
            ("big_encode", lambda: multihost.encode_tiled_multihost(
                big, TileConfig(BIG_TILE, BIG_TILE), device=dev)),
        ]
        decode_of, want = "big_encode", big
    else:
        calls = [("image_encode", lambda: multihost.encode_tiled_multihost(
            gray8[0], TileConfig(TILE, TILE), device=dev))]
        decode_of, want = "image_encode", gray8[0]
    row, results = {"backend": backend, "rank": rank, "world": world}, {}
    for name, fn in calls:
        tcd.ENCODE_LAUNCHES = 0
        results[name] = fn()
        row[f"{name}_k1_launches"] = tcd.ENCODE_LAUNCHES
        row[f"{name}_ms"] = call_ms(torch, fn, 3)[0]
    blob = results[decode_of]
    tcd.DECODE_LAUNCHES = 0
    out = multihost.decode_tiled_multihost(blob, device=dev)
    row["decode_k2_launches"] = tcd.DECODE_LAUNCHES
    if out.dtype != want.dtype or not np.array_equal(out, want):
        fail(f"{backend} rank {rank}: decode_tiled_multihost is not exact")
    row["decode_ms"] = call_ms(
        torch, lambda: multihost.decode_tiled_multihost(blob, device=dev), 3)[0]
    if backend == "gloo":
        # The decode's two steps after K2, alone: the gather of this image's
        # narrowed planes (device -> host -> gloo -> device) and the
        # assembly on the card.
        pm = multihost.global_tile_mesh(dev)
        hd = flct.read_tiled_header(blob)
        planes = torch.zeros((-(-hd.n_tiles // world), 1, BIG_TILE * BIG_TILE),
                             dtype=torch.int32, device=dev)
        row["decode_gather_ms"] = call_ms(
            torch, lambda: pm.gather_planes([mesh.narrow_planes(planes, hd)]), 3)[0]
        bufs = pm.gather_planes([mesh.narrow_planes(planes, hd)]).to(torch.int32)
        plan = tiling.decode_plan([hd], hd.tile_lengths)
        row["decode_assemble_ms"] = call_ms(torch, lambda: tiling.decode_finish(
            HostCopy(*tiling.assembled(plan, bufs[: hd.n_tiles]))), 3)[0]
    row["exact_round_trip"] = True
    blobs = results.get("corpus", []) + [blob]
    for i, b in enumerate(blobs):
        with open(os.path.join(out_dir, f"{backend}{rank}_{i}.fel"), "wb") as f:
            f.write(b)
    dist.destroy_process_group()
    print(json.dumps(row), flush=True)


def run_group(backend: str, world: int, out_dir: str) -> list:
    """Start ``world`` ranks of group_worker and wait for them (each within
    WORKER_SECONDS); fail if any fails or times out. Their JSON rows."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", backend, address,
         str(world), str(rank), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_SECONDS)[0])
    except subprocess.TimeoutExpired:
        fail(f"a {backend} worker ran past {WORKER_SECONDS} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"{backend} worker {rank} exited {p.returncode}:\n{log[-3000:]}")
        rows.append(json.loads(log.strip().splitlines()[-1]))
    return rows


def process_groups(np, card, gray8_blobs, big_single) -> dict:
    """Phase 8, process groups: two gloo ranks sharing cuda:0 (the corpus
    and the 4096^2 image), then one NCCL rank at world size 1 (one 512^2
    image). Every rank's containers must equal the other's and this
    process's compress_tiled_batch / compress_tiled_bytes, and every rank
    decodes exactly. Returns the ranks' K1/K2 launches, summed."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="felics_groups_")
    try:
        gloo = run_group("gloo", 2, out_dir)
        nccl = run_group("nccl", 1, out_dir)

        def read(name):
            with open(os.path.join(out_dir, name), "rb") as f:
                return f.read()

        want = list(gray8_blobs) + [big_single]
        for rank in range(2):
            got = [read(f"gloo{rank}_{i}.fel") for i in range(len(want))]
            if got != want:
                fail(f"gloo rank {rank}: containers differ from compress_tiled_batch / "
                     "compress_tiled_bytes")
        if read("nccl0_0.fel") != gray8_blobs[0]:
            fail("nccl rank 0: container differs from compress_tiled_bytes")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = {"encode": 0, "decode": 0}
    for row in gloo + nccl:
        k1 = [v for k, v in row.items() if k.endswith("k1_launches")]
        if not (row["decode_k2_launches"] and all(k1)):
            fail(f"{row['backend']} rank {row['rank']} did not launch K1 and K2: {row}")
        launches["encode"] += sum(k1)
        launches["decode"] += row["decode_k2_launches"]
        say("8 process group", nvidia_smi=card, **row, bytes_equal_parent=True)
    return launches


def cli_phase(np, card, images) -> dict:
    """Phase 8, the CLIs in this process on --device cuda: cfelics and
    dfelics on a 512^2 gray8 TIFF and a 512^2x3 rgb16 TIFF written by
    save_image, FLCS and --container flct --tile-size 64 (.fel bytes equal
    to the native codec's, decoded files exact), vfelics --export, and
    bfelics on 3 gray8 512^2 TIFFs (.fel and .qoi rows). Host clock per
    call. Returns the K1-K4 launches of the CLI calls."""
    import contextlib
    import io
    import shutil
    import tempfile

    from felics_tpu_torch import native
    from felics_tpu_torch.cli import bfelics, cfelics, dfelics, vfelics
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.io.images import load_image, save_image
    from felics_tpu_torch.ops import kscan as flcs_ks
    from felics_tpu_torch.ops import tile_codec as tcd

    cuda = ["--device", "cuda"]
    tmp = tempfile.mkdtemp(prefix="felics_cli_")

    def run(main, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        secs = time.perf_counter() - t0
        if rc != 0:
            fail(f"{main.__module__} {argv}: exit code {rc}: {buf.getvalue()[-2000:]}")
        return secs, buf.getvalue()

    flcs_ks.LAUNCHES = codec.DECODE_LAUNCHES = 0
    tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = 0
    try:
        rgb16 = synth((512, 512, 3), np.uint16, 1, 800, np)[0]
        cases = [("gray8", images[0], ".png"), ("rgb16", rgb16, ".tiff")]
        secs = {}
        for name, im, ext in cases:
            src = os.path.join(tmp, f"{name}.tiff")
            save_image(src, im)
            if not np.array_equal(load_image(src), im):
                fail(f"cli {name}: the TIFF save_image wrote does not load back")
            hd = header_for_array(im)
            for container, flags in (("flcs", []), ("flct", ["--container", "flct",
                                                             "--tile-size", "64"])):
                fel = os.path.join(tmp, f"{name}_{container}.fel")
                out = os.path.join(tmp, f"{name}_{container}{ext}")
                secs[f"{name}_{container}_cfelics_s"] = run(
                    cfelics.main, ["-i", src, "-o", fel, *flags, *cuda])[0]
                with open(fel, "rb") as f:
                    blob = f.read()
                want = (native.compress(im, hd) if container == "flcs"
                        else native.compress_tiled(im, hd, 64, 64))
                if blob != want:
                    fail(f"cli {name} {container}: .fel differs from the native codec")
                secs[f"{name}_{container}_dfelics_s"] = run(
                    dfelics.main, ["-i", fel, "-o", out, *cuda])[0]
                got = load_image(out)
                if got.dtype != im.dtype or not np.array_equal(got, im):
                    fail(f"cli {name} {container}: dfelics' file is not exact")
        png = os.path.join(tmp, "view.png")
        secs["vfelics_s"], printed = run(
            vfelics.main, [os.path.join(tmp, "gray8_flcs.fel"), "--export", png, *cuda])
        if not np.array_equal(load_image(png), images[0]) or "512x512" not in printed:
            fail("cli vfelics --export: the PNG is not the image")
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        for i, im in enumerate(images[:3]):
            save_image(os.path.join(corpus, f"im{i}.tiff"), im)
        secs["bfelics_s"], printed = run(
            bfelics.main, ["--corpus", corpus, "--out", os.path.join(tmp, "bench"), *cuda])
        rows = [ln.strip() for ln in printed.splitlines() if ": enc" in ln]
        if not any(r.startswith(".fel") for r in rows) or not any(
                r.startswith(".qoi") for r in rows):
            fail(f"cli bfelics: no .fel and .qoi rows in {printed!r}")
        for i, im in enumerate(images[:3]):
            with open(os.path.join(tmp, "bench", "to_felics", f"im{i}.fel"), "rb") as f:
                if f.read() != native.compress(im, header_for_array(im)):
                    fail(f"cli bfelics: im{i}.fel differs from the native codec")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"kscan": flcs_ks.LAUNCHES, "flcs_decode": codec.DECODE_LAUNCHES,
                "encode": tcd.ENCODE_LAUNCHES, "decode": tcd.DECODE_LAUNCHES}
    if not all(launches.values()):
        fail(f"the CLIs did not launch all four kernels: {launches}")
    say("8 cli", nvidia_smi=card, **secs, bfelics_rows=rows, launches=launches,
        native_bytes_identical=True, exact_round_trip=True)
    return launches


def host_backends(np, torch, dev, card, classes) -> dict:
    """Phase 9, the API's host backends and the port's scalar oracle as a
    check of K1, K2 and K4: api.compress_image_bytes under "device",
    "oracle" and "native" on gray8 128^2, rgb8 96^2x3, gray16 128^2 and
    rgb16 64^2x3 (the same bytes, each container decoded exactly under
    every backend; Mpx/s of each, best of 3 calls on the host clock after
    a warm device call); 8 tile streams of a gray8 and an rgb8 512^2 FLCT
    container written through K1 at tile 32 (v2 prior), decoded on the
    oracle in bucketed-k mode into the image's tiles and encoded back to
    the same bytes, and K2's planes of the same streams equal to the
    oracle's; K4's planes and end bit of a 128^2 gray8 FLCS payload equal
    to the oracle's; cfelics --backend oracle|native writing the .fel
    --backend device writes, dfelics under every backend writing the
    image. Returns the K1-K4 launches of the phase."""
    import contextlib
    import io
    import shutil
    import tempfile

    from felics_tpu_torch import api
    from felics_tpu_torch.cli import cfelics, dfelics
    from felics_tpu_torch.coding import BitReader
    from felics_tpu_torch.config import TileConfig, config_for_depth, tiled_config_for_depth
    from felics_tpu_torch.core import codec, oracle
    from felics_tpu_torch.device import upload_image
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.io.images import load_image, save_image
    from felics_tpu_torch.ops import kscan as flcs_ks
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import flct, tiling

    def timed(fn, reps=3):
        """fn()'s result and its least host seconds over `reps` calls."""
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, min(secs)

    images = {
        "gray8": synth((128, 128), np.uint8, 1, 6, np)[0],
        "rgb8": synth((96, 96, 3), np.uint8, 1, 6, np)[0],
        "gray16": synth((128, 128), np.uint16, 1, 800, np)[0],
        "rgb16": synth((64, 64, 3), np.uint16, 1, 800, np)[0],
    }
    flcs_ks.LAUNCHES = codec.DECODE_LAUNCHES = 0
    tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = 0
    for name, im in images.items():
        api.decompress_image_bytes(api.compress_image_bytes(im, device=dev), device=dev)  # warm
        px = im.shape[0] * im.shape[1]
        row, blobs = {}, {}
        for b in api.BACKENDS:
            blobs[b], secs = timed(lambda: api.compress_image_bytes(im, device=dev, backend=b))
            row[f"{b}_encode_mpx_s"] = px / secs / 1e6
        if not blobs["device"] == blobs["oracle"] == blobs["native"]:
            fail(f"host backends {name}: the three backends wrote different bytes")
        for b in api.BACKENDS:
            out, secs = timed(lambda: api.decompress_image_bytes(
                blobs["device"], device=dev, backend=b))
            if out.dtype != im.dtype or not np.array_equal(out, im):
                fail(f"host backends {name}: the {b} decode is not exact")
            row[f"{b}_decode_mpx_s"] = px / secs / 1e6
        say("9 backends", nvidia_smi=card, cls=name, shape=list(im.shape),
            bytes_identical=True, exact_under_every_backend=True, **row)

    # K1's tile streams and K2's planes against the oracle.
    tc = TileConfig(TILE, TILE)
    for name, ims in classes[:2]:
        im = ims[0]
        blob = tiling.compress_tiled_bytes(im, tc, device=dev)
        hd = flct.read_tiled_header(blob)
        cfg = tiled_config_for_depth(hd.pixel_depth)
        c = hd.num_channels
        prior = flct.prior_from_k0(hd.k0, cfg, c)
        tiles = tiling.image_tiles(upload_image(im, dev)[None], TILE, TILE).cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(hd.tile_lengths)]) + hd.payload_off
        pick = np.linspace(0, hd.n_tiles - 1, 8).astype(int)
        streams = [blob[offs[t]:offs[t + 1]] for t in pick]
        t0 = time.perf_counter()
        planes = []
        for t, stream in zip(pick, streams):
            got, end = oracle.decompress_tile(stream, TILE, TILE, c, cfg, prior)
            if end > 8 * len(stream) or not np.array_equal(got, tiles[t]):
                fail(f"K1 {name} tile {t}: the oracle does not decode K1's stream to the tile")
            again, bits = oracle.compress_tile(tiles[t], TILE, TILE, cfg, prior)
            if bits != end or again != stream[:len(again)]:
                fail(f"K1 {name} tile {t}: the oracle encodes the tile to other bits")
            planes.append(got)
        oracle_s = time.perf_counter() - t0
        lens = np.array([len(s) for s in streams], np.int64)
        rows, prior_t = container_rows(hd, lens, streams, dev)
        k2 = tcd.decode_tiles(rows, cfg, TILE, TILE, c, prior_t).cpu().numpy()
        if not np.array_equal(k2, np.stack(planes)):
            fail(f"K2 {name}: planes differ from the oracle's")
        say("9 K1 K2 vs oracle", cls=name, tiles=pick.tolist(), stream_bytes=lens.tolist(),
            oracle_s=oracle_s, k1_streams_decode_to_tiles=True,
            oracle_reencodes_k1_bits=True, k2_equals_oracle=True)

    # K4 against the oracle.
    im = images["gray8"]
    h, w = im.shape
    cfg = config_for_depth(header_for_array(im).pixel_depth)
    payload = api.compress_image_bytes(im, device=dev)[14:]
    words = torch.from_numpy(codec.payload_words([payload]).view(np.int32)).to(dev)
    k4, end, _ = codec.decode_scan(words, h, w, cfg, 1)
    reader = BitReader(payload)
    want = oracle.decompress_channel(w, h, cfg, reader)
    if not np.array_equal(k4[0, 0].cpu().numpy(), want) or int(end[0]) != reader.bit_position:
        fail("K4 gray8 128^2: planes or end bit differ from the oracle's")
    say("9 K4 vs oracle", cls="gray8", shape=[h, w], end_bit=reader.bit_position,
        k4_equals_oracle=True)

    # The CLIs' --backend.
    tmp = tempfile.mkdtemp(prefix="felics_backend_")
    try:
        for name in ("gray8", "rgb16"):
            src = os.path.join(tmp, f"{name}.tiff")
            save_image(src, images[name])
            ext = ".tiff" if name == "rgb16" else ".png"
            fels = {}
            for b in api.BACKENDS:
                fel, out = os.path.join(tmp, f"{name}_{b}.fel"), os.path.join(tmp, f"{name}_{b}{ext}")
                for main, argv in ((cfelics.main, ["-i", src, "-o", fel]),
                                   (dfelics.main, ["-i", os.path.join(tmp, f"{name}_device.fel"),
                                                   "-o", out])):
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = main([*argv, "--backend", b, "--device", "cuda"])
                    if rc != 0:
                        fail(f"{main.__module__} --backend {b}: exit code {rc}: {buf.getvalue()}")
                with open(fel, "rb") as f:
                    fels[b] = f.read()
                got = load_image(out)
                if got.dtype != images[name].dtype or not np.array_equal(got, images[name]):
                    fail(f"cli {name} --backend {b}: dfelics' file is not exact")
            if not fels["device"] == fels["oracle"] == fels["native"]:
                fail(f"cli {name}: --backend oracle|native .fel differs from --backend device")
        say("9 cli", fel_identical=True, exact=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"kscan": flcs_ks.LAUNCHES, "flcs_decode": codec.DECODE_LAUNCHES,
                "encode": tcd.ENCODE_LAUNCHES, "decode": tcd.DECODE_LAUNCHES}
    if not all(launches.values()):
        fail(f"phase 9 did not launch all four kernels: {launches}")
    say("9 done", launches=launches)
    return launches


def edge_classes(np):
    """Phase 10's batches: one image of uniform noise for every shape of
    the 0..20 x 0..20 grid, per class (seeded)."""
    kinds = (("gray8", np.uint8, ()), ("gray16", np.uint16, ()),
             ("rgb8", np.uint8, (3,)), ("rgb16", np.uint16, (3,)))
    out = []
    for seed, (name, dtype, extra) in enumerate(kinds):
        rng = np.random.default_rng(10 + seed)
        hi = np.iinfo(dtype).max + 1
        out.append((name, [rng.integers(0, hi, (h, w) + extra).astype(dtype)
                           for h in EDGE_SIDES for w in EDGE_SIDES]))
    return out


def edge_tile_kernels(torch, dev, name, images, tile) -> int:
    """K1 and K2 on ``images`` at ``tile``, one geometry group at a time as
    the batched call groups them, against their plain versions run on the
    CPU on the same inputs: words, bit counts and planes exact, the planes
    equal to the tiles. Returns the number of groups."""
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import batch, tiling

    _, _, groups = batch.geometry_groups(images, tile)
    for (th, tw, _, _), idx in groups.items():
        grp = [images[i] for i in idx]
        p = tiling.encode_dispatch(grp, [header_for_array(im) for im in grp], th, tw,
                                   True, dev)
        tiling.encode_finish(p)
        c = p.tiles.shape[1]
        wk, bk = tcd.encode_tiles(p.tiles, p.plan.cfg, th, tw, p.W, p.prior)
        dk = tcd.decode_tiles(wk, p.plan.cfg, th, tw, c, p.prior)
        tiles, prior, wk, bk, dk = (t.cpu() for t in (p.tiles, p.prior, wk, bk, dk))
        wr, br = tcd.encode_tiles_ref(tiles, p.plan.cfg, th, tw, p.W, prior)
        dr = tcd.decode_tiles_ref(wk, p.plan.cfg, th, tw, c, prior)
        if not (torch.equal(wk, wr) and torch.equal(bk, br) and torch.equal(dk, dr)
                and torch.equal(dk, tiles)):
            fail(f"10 edges {name} at tile {th}x{tw} ({len(grp)} images): K1/K2 "
                 "differ from their plain versions or the tiles")
    return len(groups)


def edge_scan_kernels(np, torch, dev, name, images, blobs) -> None:
    """K3 and K4 on each image (one launch a shape, as the API groups
    them) against kscan_ref and decode_scan_scalar run on the CPU on the
    same inputs, K4 on the image's container from the main path: k per
    pixel, planes, end bit and overrun flag exact, the planes the image's."""
    from felics_tpu_torch.config import config_for_depth
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import analysis, kscan

    for im, blob in zip(images, blobs):
        hd = header_for_array(im)
        h, w, c = hd.height, hd.width, hd.num_channels
        cfg = config_for_depth(hd.pixel_depth)
        chans = codec._image_channels([im], hd, dev)
        a = analysis.analyze_channel(chans, h, w)
        su = kscan.sort_updates(a.context, a.oor)
        k3 = kscan.kscan(a.residual, su, cfg).cpu().long()
        k3_ref = kscan.kscan_ref(a.residual.cpu(), kscan.SortedUpdates(*(t.cpu() for t in su)),
                                 cfg)
        words = torch.from_numpy(codec.payload_words([blob[14:]]).view(np.int32))
        k4 = [t.cpu() for t in codec.decode_scan(words.to(dev), h, w, cfg, c)]
        ref = codec.decode_scan_scalar(words, h, w, cfg, c)
        if not (torch.equal(k3, k3_ref) and all(torch.equal(g, r) for g, r in zip(k4, ref))
                and torch.equal(k4[0][0], chans.cpu()) and not bool(k4[2].any())):
            fail(f"10 edges {name} {h}x{w}: K3/K4 differ from their plain versions "
                 "or the image")


def edges(np, torch, dev, card) -> dict:
    """Phase 10 (the module docstring says what it checks). Returns the
    K1-K4 launches of its main-path run."""
    import struct

    from felics_tpu_torch import api, compress_tiled_batch, decompress_tiled_batch, native
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import kscan as flcs_ks
    from felics_tpu_torch.ops import tile_codec as tcd

    def counts():
        return {"encode": tcd.ENCODE_LAUNCHES, "decode": tcd.DECODE_LAUNCHES,
                "kscan": flcs_ks.LAUNCHES, "flcs_decode": codec.DECODE_LAUNCHES}

    def zero_counts():
        tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = 0
        flcs_ks.LAUNCHES = codec.DECODE_LAUNCHES = 0

    def drive(images):
        """The main path on one batch: FLCS (containers, images) and, per
        tile, FLCT (containers, images)."""
        blobs = api.compress_images_bytes(images, device=dev)
        flct = {}
        for th, tw in EDGE_TILES:
            tb = compress_tiled_batch(images, TileConfig(th, tw), device=dev)
            flct[(th, tw)] = (tb, decompress_tiled_batch(tb, device=dev))
        return (blobs, api.decompress_images_bytes(blobs, device=dev)), flct

    def exact(out, im, what):
        if out.dtype != im.dtype or out.shape != im.shape or not np.array_equal(out, im):
            fail(f"10 edges {what} {im.dtype} {im.shape}: the decode is not exact")

    t0 = time.perf_counter()
    classes = edge_classes(np)
    empty = [im for _, ims in classes for im in ims if im.size == 0]
    zero_counts()
    drive(empty)
    if any(counts().values()):
        fail(f"10 edges: zero-area images launched kernels: {counts()}")

    zero_counts()
    t1 = time.perf_counter()
    ran = {name: drive(images) for name, images in classes}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = counts()
    if not all(launches.values()):
        fail(f"10 edges: the grid did not launch all four kernels: {launches}")

    t2 = time.perf_counter()
    for name, images in classes:
        (flcs, flcs_out), flct = ran[name]
        for i, im in enumerate(images):
            hd = header_for_array(im)
            if flcs[i] != native.compress(im, hd):
                fail(f"10 edges FLCS {name} {im.shape}: differs from the native codec")
            exact(flcs_out[i], im, "FLCS")
        for (th, tw), (blobs, outs) in flct.items():
            natives = [native.compress_tiled(im, header_for_array(im), tw, th) for im in images]
            for im, blob, out, nat in zip(images, blobs, outs, natives):
                if im.size == 0:
                    # native clamps a header-only container's tile fields
                    # to the image; felics_tpu writes max(2, tile)
                    nat = nat[:14] + struct.pack(">HH", max(2, tw), max(2, th)) + nat[18:]
                if blob != nat:
                    fail(f"10 edges FLCT {name} {im.shape} tile {th}x{tw}: "
                         "differs from the native codec")
                exact(out, im, f"FLCT tile {th}x{tw}")
            for im, out in zip(images, decompress_tiled_batch(natives, device=dev)):
                exact(out, im, f"FLCT of native, tile {th}x{tw}")
    native_s = time.perf_counter() - t2

    t3 = time.perf_counter()
    groups = {}
    for name, images in classes:
        rows = [im for im in images if 1 in im.shape[:2]]
        groups[name] = {"2x2": edge_tile_kernels(torch, dev, name, images, TileConfig(2, 2))}
        for th, tw in EDGE_TILES[1:]:
            groups[name][f"{th}x{tw} rows"] = edge_tile_kernels(
                torch, dev, name, rows, TileConfig(th, tw))
        flcs_blobs = ran[name][0][0]
        scans = [(im, b) for im, b in zip(images, flcs_blobs)
                 if 1 in im.shape[:2] and im.shape[0] * im.shape[1] >= 2]
        edge_scan_kernels(np, torch, dev, name, *zip(*scans))
        groups[name]["flcs rows"] = len(scans)
    kernels_s = time.perf_counter() - t3
    say("10 edges", nvidia_smi=card, seconds=time.perf_counter() - t0, run_s=run_s,
        native_check_s=native_s, kernel_check_s=kernels_s,
        classes=[name for name, _ in classes], shapes_per_class=len(classes[0][1]),
        zero_area_per_class=sum(im.size == 0 for im in classes[0][1]),
        flcs_scans_per_class=sum(im.shape[0] * im.shape[1] >= 2 for im in classes[0][1]),
        tiles=[f"{th}x{tw}" for th, tw in EDGE_TILES], launches=launches,
        kernel_check_groups=groups, native_bytes_identical=True, exact_decodes=True,
        kernels_equal_plain_versions=True, zero_area_launches=0)
    return launches


@contextlib.contextmanager
def eager_chains():
    """Every FLCT group on the eager chains (tiling.encode_dispatch /
    decode_dispatch) while the context lasts: the entry points as they ran
    before the graph cache, to time beside it in one call."""
    from felics_tpu_torch.parallel import tiling

    saved = tiling.encode_group_dispatch, tiling.decode_group_dispatch
    tiling.encode_group_dispatch = tiling.encode_dispatch
    tiling.decode_group_dispatch = tiling.decode_dispatch
    try:
        yield
    finally:
        tiling.encode_group_dispatch, tiling.decode_group_dispatch = saved


def host_launches(prof) -> dict:
    """Calls of the CUDA runtime's launch and copy functions in a
    profiled window, by name (kernel launches, graph launches, copies)."""
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("cu") and ("Launch" in e.key or "Memcpy" in e.key)}


def graph_phase(np, torch, dev, card, classes) -> dict:
    """Phase 11, the CUDA graphs of the same-shape FLCT chains: for each
    of GRAPH_RUNS, the batched pair and phase 7's stream calls on the
    graph path and on the eager chains (eager_chains), in one call:
    containers byte-identical to the native codec and to the eager chain,
    exact decodes, K1 and K2 run inside the replays (counters, and the
    profiler's kernels under a graph launch); best ms of 3 calls (CUDA
    events, after GRAPH_WARM warm calls) of each mode in turns eager,
    graph, graph, eager; host launches a call and the device's idle share
    over a profiled window of one-shot calls a direction (profiled_calls);
    the graphs' pool bytes. Returns the K1/K2 launches and the replays and
    captures of the graph runs alone: each count set to 0 just before them
    and read just after."""
    from felics_tpu_torch import compress_tiled_batch, decompress_tiled_batch, native
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.format import header_for_array
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import graphs

    t11 = time.perf_counter()
    by_name = dict(classes)
    counts = {"encode": 0, "decode": 0, "replays": {"encode": 0, "decode": 0},
              "captures": {"encode": 0, "decode": 0}}
    for name, tile in GRAPH_RUNS:
        images = by_name[name]
        tc = TileConfig(tile, tile)
        n = STREAM_CHUNKS[name]
        chunks = [images[i : i + n] for i in range(0, len(images), n)]
        with eager_chains():
            eager_blobs = compress_tiled_batch(images, tc, device=dev)
        for im, blob in zip(images, eager_blobs):
            if blob != native.compress_tiled(im, header_for_array(im), tile, tile):
                fail(f"graphs {name} t{tile}: the eager chain's container differs from native")

        # The graph path, counted: warm calls, then checked calls that replay.
        tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = 0
        for d in ("encode", "decode"):
            graphs.REPLAYS[d] = graphs.CAPTURES[d] = 0
        for _ in range(GRAPH_WARM + 1):
            blobs = compress_tiled_batch(images, tc, device=dev)
            outs = decompress_tiled_batch(blobs, device=dev)
            if blobs != eager_blobs:
                fail(f"graphs {name} t{tile}: containers differ from the eager chain's")
            if any(o.dtype != im.dtype or not np.array_equal(o, im)
                   for o, im in zip(outs, images)):
                fail(f"graphs {name} t{tile}: a decode is not exact")
        streamed = graph_stream_checked(np, dev, tc, chunks, eager_blobs, images)
        launched = {"encode": tcd.ENCODE_LAUNCHES, "decode": tcd.DECODE_LAUNCHES,
                    "replays": dict(graphs.REPLAYS), "captures": dict(graphs.CAPTURES)}
        if not (launched["replays"]["encode"] and launched["replays"]["decode"]
                and launched["encode"] and launched["decode"]):
            fail(f"graphs {name} t{tile}: no replay, or K1/K2 never ran: {launched}")
        for k in ("encode", "decode"):
            counts[k] += launched[k]
            counts["replays"][k] += launched["replays"][k]
            counts["captures"][k] += launched["captures"][k]

        calls = stream_calls(tc, dev, images, chunks, eager_blobs, streamed)
        best: dict = {}
        for mode in ("eager", "graph", "graph", "eager"):
            with eager_chains() if mode == "eager" else contextlib.nullcontext():
                for call, fn in calls.items():
                    for _ in range(GRAPH_WARM):
                        fn()
                    ms = call_ms(torch, fn, 3)[1]
                    best[(mode, call)] = min(best.get((mode, call), ms), ms)
        px = sum(im.shape[0] * im.shape[1] for im in images)
        row = {}
        for mode in ("eager", "graph"):
            for run in ("one_shot", "stream", "stream_d1", "batched"):
                e, d = best[(mode, f"{run}_encode")], best[(mode, f"{run}_decode")]
                row[f"{mode}_{run}_encode_ms"] = e
                row[f"{mode}_{run}_decode_ms"] = d
                row[f"{mode}_{run}_mpx_s"] = 2 * px / (e + d) / 1e3
            row[f"{mode}_d2_over_b2b"] = row[f"{mode}_stream_mpx_s"] / row[f"{mode}_batched_mpx_s"]
            row[f"{mode}_b2b_over_one_shot"] = (row[f"{mode}_batched_mpx_s"]
                                                / row[f"{mode}_one_shot_mpx_s"])
            # Profiled one-shot calls a direction (after warm calls), per
            # call: host launches, the kernels the device ran, the idle share.
            for d, fn in (("encode", calls["one_shot_encode"]),
                          ("decode", calls["one_shot_decode"])):
                kernel = "flct_encode_kernel" if d == "encode" else "flct_decode_kernel"
                with eager_chains() if mode == "eager" else contextlib.nullcontext():
                    prof, wall_us, tries = profiled_calls(torch, fn, kernel)
                per = 1 / PROFILE_CALLS
                row[f"{mode}_{d}_profile_tries"] = tries
                row[f"{mode}_{d}_host_calls"] = {
                    k: v * per for k, v in host_launches(prof).items()}
                row[f"{mode}_{d}_device_kernels"] = per * sum(
                    1 for e in prof.events() if e.device_type.name == "CUDA"
                    and "Memcpy" not in e.name and "Memset" not in e.name)
                row[f"{mode}_{d}_{kernel}"] = per * sum(
                    1 for e in prof.events()
                    if e.device_type.name == "CUDA" and kernel in e.name)
                row[f"{mode}_{d}_idle_share"] = 1 - device_busy_us(prof) / wall_us
                row[f"{mode}_{d}_profiled_wall_ms"] = wall_us * per / 1e3
                row[f"{mode}_{d}_top_host_self_ms"] = [
                    [e.key, e.self_cpu_time_total * per / 1e3, e.count * per] for e in sorted(
                        prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:6]]
            if not row[f"{mode}_encode_flct_encode_kernel"] or not row[
                    f"{mode}_decode_flct_decode_kernel"]:
                seen = {k: v for k, v in row.items() if k.startswith(mode) and (
                    "device_kernels" in k or "_kernel" in k or "host_calls" in k)}
                fail(f"graphs {name} t{tile} {mode}: the profiler saw no K1 or K2 in "
                     f"{PROFILE_TRIES + 1} windows of {PROFILE_CALLS} calls: {seen}")
        say("11 graphs", nvidia_smi=card, cls=name, tile=tile, images=len(images),
            chunk=n, launches=launched, bytes_equal_native=True, bytes_equal_eager=True,
            exact_round_trip=True, **row)
    pools = [{"key": [str(g.key.direction), g.key.tile_h, g.key.tile_w, g.key.num_channels,
                      str(g.key.pixel_depth), len(g.key.dims), *g.key.dims[0]],
              "pool_bytes": g.pool_bytes,
              "input_bytes": g.dev_in.numel()} for g in graphs.cache(dev).graphs]
    say("11 pools", nvidia_smi=card, graphs=len(pools),
        pool_bytes=sum(p["pool_bytes"] for p in pools),
        input_bytes=sum(p["input_bytes"] for p in pools),
        max_bytes=graphs.cache(dev).max_bytes, by_graph=pools,
        seconds=time.perf_counter() - t11)
    graph_churn(np, torch, dev, card)
    return counts


def graph_churn(np, torch, dev, card) -> None:
    """Phase 11, the cache's bound on the card: gray8 512^2 batches of 1 to
    GRAPH_CHURN images at tile 32, each key captured (its second call) and
    replayed (its third), under a bound cut to GRAPH_CHURN_BYTES. After
    every call the bytes of the cached graphs plus those of the evicted
    ones not handed back yet stay within the bound, and evicted pools are
    handed back; every container equals the eager chain's."""
    from felics_tpu_torch import compress_tiled_batch
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.parallel import graphs

    t0 = time.perf_counter()
    tc = TileConfig(TILE, TILE)
    cache = graphs.cache(dev)
    saved, cache.max_bytes = cache.max_bytes, GRAPH_CHURN_BYTES
    cache.trim()
    releases, base = cache.releases, torch.cuda.memory_reserved(dev)
    peak, held = 0, 0
    try:
        for n in range(1, GRAPH_CHURN + 1):
            images = synth((512, 512), np.uint8, n, 6, np)
            with eager_chains():
                want = compress_tiled_batch(images, tc, device=dev)
            for _ in range(3):
                if compress_tiled_batch(images, tc, device=dev) != want:
                    fail(f"graph churn, {n} images: containers differ from the eager chain's")
                held = max(held, cache.dropped + sum(g.nbytes for g in cache.graphs))
                if cache.dropped + sum(g.nbytes for g in cache.graphs) > cache.max_bytes:
                    fail(f"graph churn, {n} images: {cache.dropped} evicted and "
                         f"{sum(g.nbytes for g in cache.graphs)} cached bytes pass the "
                         f"bound of {cache.max_bytes}")
                peak = max(peak, torch.cuda.memory_reserved(dev) - base)
        if cache.releases == releases:
            fail("graph churn: no evicted pool was handed back")
    finally:
        cache.max_bytes = saved
    say("11 churn", nvidia_smi=card, batches=GRAPH_CHURN, bound_bytes=GRAPH_CHURN_BYTES,
        most_held_bytes=held, releases=cache.releases - releases,
        reserved_growth_peak_bytes=peak, graphs=len(cache.graphs),
        bytes_equal_eager=True, seconds=time.perf_counter() - t0)


def profiled_calls(torch, fn, kernel: str):
    """(profiler, wall us, windows taken) of PROFILE_CALLS calls of fn()
    under torch.profiler, after two warm calls. The profiler's device
    records of a window can come back short (on some H100 hosts a few
    kernels of each window are missing): a window whose records hold no
    kernel named ``kernel`` is profiled again, PROFILE_TRIES windows with
    CPU and CUDA activities, then one with CUDA alone (the sessions of
    ``profiled``); the last one is returned either way."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for tries, acts in enumerate([both] * PROFILE_TRIES + [[ProfilerActivity.CUDA]], 1):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_CALLS):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if any(e.device_type.name == "CUDA" and kernel in e.name for e in prof.events()):
            break
    return prof, wall_us, tries


def graph_stream_checked(np, dev, tc, chunks, blobs, images):
    """Phase 11: the stream pair on the graph path over the chunks, held to
    the eager containers and to the images; returns the streamed batches."""
    from felics_tpu_torch import compress_tiled_stream, decompress_tiled_stream

    for _ in range(GRAPH_WARM):
        streamed = compress_tiled_stream(iter(chunks), tc, depth=STREAM_DEPTH, device=dev)
        outs = decompress_tiled_stream(iter(streamed), depth=STREAM_DEPTH, device=dev)
        if [b for batch in streamed for b in batch] != blobs:
            fail("graphs: the stream's containers differ from the eager chain's")
        if any(not np.array_equal(o, im)
               for o, im in zip([o for batch in outs for o in batch], images)):
            fail("graphs: a streamed decode is not exact")
    return streamed


def profiled(torch, fn, kernel: str):
    """fn()'s result and the device ms of the kernels whose name holds
    `kernel` in that one call, from torch.profiler (None when it saw no
    such kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type.name == "CUDA" and kernel in e.name]
    return out, sum(spans) / 1e3 if spans else None


def ptxas_frames(log: str) -> dict:
    """{function: (stack frame, spill store, spill load bytes)} from the
    ``nvcc -Xptxas=-v`` output of a build."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            cur = ln.split("Function properties for ", 1)[1].strip()
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur:
            out[cur] = tuple(int(g) for g in m.groups())
            cur = None
    return out


def device_ms(torch, fn, kernel: str, reps: int = 10):
    """Mean device time (ms) of the kernels whose name holds `kernel` over
    `reps` calls of fn, from torch.profiler (one warm call first); None
    when the profiler saw no such kernel."""
    fn()
    torch.cuda.synchronize()
    _, ms = profiled(torch, lambda: [fn() for _ in range(reps)], kernel)
    return None if ms is None else ms / reps


def need_gpu_and_repo():
    """(numpy, torch) once a GPU and the repository are there; else fail."""
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"numpy and torch are needed: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "felics_tpu_torch")):
        fail("felics_tpu_torch/ not found beside chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, REPO)
    return np, torch


def main() -> None:
    np, torch = need_gpu_and_repo()

    from felics_tpu_torch import (
        compress_tiled_batch, decompress_tiled_batch, decompress_tiled_bytes,
        errors, native,
    )
    from felics_tpu_torch.config import TileConfig, tiled_config_for_depth
    from felics_tpu_torch.device import upload_image
    from felics_tpu_torch.format import PixelDepth, header_for_array
    from felics_tpu_torch.ops import _build
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import flct, graphs, tiling

    dev = torch.device("cuda")
    card = smi()
    props = torch.cuda.get_device_properties(0)

    # ---- phase 1: card and toolchain ------------------------------------
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BuildInfo.log.splitlines()
             if "registers" in ln or "stack frame" in ln]
    frames = ptxas_frames(_build.BuildInfo.log)
    say("1 card", nvidia_smi=card, sms=props.multi_processor_count,
        torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        python=sys.version.split()[0], build_s=round(build_s, 3),
        nvcc_s=_build.BuildInfo.seconds, ptxas=ptxas)
    # K1 and K2 keep their state in registers and shared memory: no stack
    # frame, no spills (checked when this run built the library). K1 has 2
    # instantiations (K 6, 15), K2 8 (K x ring in shared memory or not x
    # 32- or 64-bit positions).
    flct_frames = {f: v for f, v in frames.items()
                   if "flct_encode_kernel" in f or "flct_decode_kernel" in f}
    if _build.BuildInfo.seconds and (
            len(flct_frames) < 10 or any(any(v) for v in flct_frames.values())):
        fail(f"K1/K2 ptxas (stack, spill stores, spill loads): {flct_frames}")
    say("1 ptxas K1 K2", stack_spill_st_spill_ld=flct_frames)
    say("1 ptxas K5", stack_spill_st_spill_ld={
        f: v for f, v in frames.items() if "flct_k0_" in f})

    # ---- phase 2: kernels against their plain versions ------------------
    def both_ways(name, tiles, prior, cfg, th, tw, W):
        """Encode and decode with the kernels and the plain versions on the
        same device inputs; every output must agree exactly. Returns both
        errors and the plain versions' ms (host clock, synchronised)."""
        c = tiles.shape[1]
        wk, bk = tcd.encode_tiles(tiles, cfg, th, tw, W, prior)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wr, br = tcd.encode_tiles_ref(tiles, cfg, th, tw, W, prior)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        enc_err = max(int((wk.long() - wr.long()).abs().max()),
                      int((bk - br).abs().max()))
        dk = tcd.decode_tiles(wk, cfg, th, tw, c, prior)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dr = tcd.decode_tiles_ref(wk, cfg, th, tw, c, prior)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        dec_err = int((dk.long() - dr.long()).abs().max())
        rt_err = int((dk.long() - tiles.long()).abs().max())
        if enc_err or dec_err or rt_err or int(bk.max()) > 32 * W:
            fail(f"{name}: kernel vs plain enc_err={enc_err} dec_err={dec_err}"
                 f" round_trip_err={rt_err} max_bits={int(bk.max())} W={W}")
        return enc_err, dec_err, {"encode_plain_ms": (t1 - t0) * 1e3,
                                  "decode_plain_ms": (t3 - t2) * 1e3}

    # The native C++ codec, which phases 2-7 hold the containers to.
    subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")],
                   check=True, capture_output=True)
    errs = {"encode": 0, "decode": 0}
    cases = [
        ("gray8 16x16 t8 zero prior", (16, 16), 255, (8, 8), True, False),
        ("gray8 16x16 t8 prior", (16, 16), 255, (8, 8), True, True),
        ("rgb8 16x16x3 t8", (16, 16, 3), 255, (8, 8), True, True),
        ("rgb16 8x8x3 t4", (8, 8, 3), 65535, (4, 4), False, True),
        ("gray16 16x24 t8", (16, 24), 65535, (8, 8), True, True),
        ("gray8 13x9 t5x3", (13, 9), 255, (5, 3), False, True),
        ("gray8 45x50 t40x24", (45, 50), 255, (40, 24), True, True),
    ]
    for i, (name, shape, dmax, (th, tw), smooth, use_prior) in enumerate(cases):
        img = small_image(shape, dmax, 100 + i, smooth, np)
        hd = header_for_array(img)
        cfg = tiled_config_for_depth(hd.pixel_depth)
        th, tw = flct.clamped_tile_dims(hd.height, hd.width, TileConfig(th, tw))
        tiles = tiling.image_tiles(upload_image(img, dev)[None], th, tw)
        nt, c, t = tiles.shape
        if use_prior:
            k0, prior = tiling.k0_prior(tiles, [nt], th, tw, cfg)
            want_k0, want_prior = tiling.k0_prior_ref(tiles, [nt], th, tw, cfg)
            if not (torch.equal(k0, want_k0) and torch.equal(prior, want_prior)):
                fail(f"{name}: K5 differs from its plain version")
        else:
            prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k),
                                dtype=torch.int32, device=dev)
        e, d, _ = both_ways(name, tiles, prior, cfg, th, tw,
                            tcd.encode_width_bound(cfg, t, c))
        errs["encode"], errs["decode"] = max(errs["encode"], e), max(errs["decode"], d)
        say("2 kernels", case=name, tiles=nt, enc_err=e, dec_err=d)

    # Noise on a checkerboard of dark and bright cells, under a prior that
    # holds every bucket at k = 0: each pixel costs ~230 bits, far past the
    # first width hint (~20 bits a pixel); both kernels at the exact width.
    cfg8 = tiled_config_for_depth(PixelDepth.EIGHT)
    noise = checker_noise(16, 16, 7, np)
    tiles = tiling.image_tiles(upload_image(noise, dev)[None], 8, 8)
    nt, c, t = tiles.shape
    k0_bias = torch.full((c, tcd.num_buckets(cfg8), cfg8.num_k), 1 << 20,
                         dtype=torch.int32, device=dev)
    k0_bias[..., 0] = 0
    hint = tcd.width_hint(cfg8, t, c)
    max_bits = int(tcd.encode_tiles(tiles, cfg8, 8, 8, hint, k0_bias)[1].max())
    W = tiling.exact_width(max_bits)
    e, d, _ = both_ways("gray8 noise k=0 prior", tiles, k0_bias, cfg8, 8, 8, W)
    errs["encode"], errs["decode"] = max(errs["encode"], e), max(errs["decode"], d)
    say("2 kernels", case="gray8 noise k=0 prior", first_W=hint, W=W,
        max_bits=max_bits, enc_err=e, dec_err=d)

    # The finish half's relaunch, the one every caller takes: 64x64 noise at
    # tile 32 under a width hint held at its smallest bucket (64 words, 2
    # bits a pixel), as if the widest stream seen had been one word.
    # encode_finish must launch K1 once more, at the exact width; its words
    # must equal a direct launch there, both kernels their plain versions,
    # and the container the native codec's. The hints are put back after.
    noise = checker_noise(64, 64, 8, np)
    hd = header_for_array(noise)
    saved = dict(tcd._w_hints), dict(tiling._cap_hints)
    tcd._w_hints[(TILE * TILE, 1, hd.pixel_depth)] = 1
    before = tcd.ENCODE_LAUNCHES
    p = tiling.encode_dispatch([noise], [hd], TILE, TILE, True, dev)
    hint = p.W
    blob = tiling.encode_finish(p)[0]
    relaunches = tcd.ENCODE_LAUNCHES - before - 1
    tcd._w_hints, tiling._cap_hints = saved
    max_bits = int(p.bits.max())
    if not (hint == 64 and relaunches == 1 and p.W == tiling.exact_width(max_bits) > hint):
        fail(f"encode_finish did not relaunch once at the exact width (hint {hint}, "
             f"W {p.W}, {relaunches} relaunches, {max_bits} bits)")
    wk, bk = tcd.encode_tiles(p.tiles, p.plan.cfg, TILE, TILE, p.W, p.prior)
    if not (torch.equal(wk, p.words) and torch.equal(bk, p.bits)):
        fail("encode_finish's relaunch differs from a direct launch at that width")
    if blob != native.compress_tiled(noise, hd, TILE, TILE):
        fail("the relaunched container differs from the native codec")
    e, d, _ = both_ways("gray8 64x64 noise t32, relaunched W", p.tiles, p.prior, p.plan.cfg,
                        TILE, TILE, p.W)
    errs["encode"], errs["decode"] = max(errs["encode"], e), max(errs["decode"], d)
    say("2 kernels", case="gray8 noise relaunch in encode_finish", first_W=hint,
        relaunch_W=p.W, max_bits=max_bits, enc_err=e, dec_err=d,
        native_bytes_identical=True)

    # Garbage words (random, and all ones: an endless unary run) for K2,
    # both depths and 1 or 3 planes.
    rng2 = np.random.default_rng(2)
    for depth, c in ((PixelDepth.EIGHT, 1), (PixelDepth.SIXTEEN, 3)):
        cfg = tiled_config_for_depth(depth)
        rows = torch.from_numpy(
            rng2.integers(-(1 << 31), 1 << 31, (40, 8)).astype(np.int32)).to(dev)
        rows[1] = -1
        prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k), dtype=torch.int32,
                            device=dev)
        dk = tcd.decode_tiles(rows, cfg, 4, 4, c, prior)
        d = int((dk.long() - tcd.decode_tiles_ref(rows, cfg, 4, 4, c, prior).long())
                .abs().max())
        if d:
            fail(f"garbage words, {depth.name} C={c}: K2 differs from its plain version")
        errs["decode"] = max(errs["decode"], d)
        say("2 kernels", case=f"garbage words {depth.name} C={c}", rows=40, dec_err=d)

    # ---- phase 3: the main path at full size ----------------------------
    classes = flct_classes(np)

    # Both kernels against their plain versions at each class's batch shape
    # (tile 32), exact, and timed there (kernel: mean of 10 warm launches;
    # plain: its one comparison run); then timed on gray8 at the default
    # tile 64 (no plain version there: it would take ~4x as long).
    kt = {}
    for name, images in classes:
        ks = flct_kernel_inputs(torch, dev, images, TILE)
        e, d, plain = both_ways(f"{name} {len(images)}x512^2 t{TILE}", ks["tiles"],
                                ks["prior"], ks["cfg"], TILE, TILE, ks["words"].shape[1])
        errs["encode"], errs["decode"] = max(errs["encode"], e), max(errs["decode"], d)
        kt[name] = {**flct_kernel_times(torch, ks), **plain}
        say("3 kernels", nvidia_smi=card, cls=name, enc_err=e, dec_err=d,
            **{k: v for k, v in kt[name].items() if not k.endswith("bound")})
    ks = flct_kernel_inputs(torch, dev, classes[0][1], 64)
    kt["gray8 t64"] = flct_kernel_times(torch, ks)
    say("3 kernels", nvidia_smi=card, cls="gray8",
        **{k: v for k, v in kt["gray8 t64"].items() if not k.endswith("bound")})
    # K2 at the serve stream's chunk (K2_CHUNK gray8 images at tile 64: 192
    # tiles, one a block), where each chain has a warp to itself.
    ks = flct_kernel_inputs(torch, dev, classes[0][1][:K2_CHUNK], 64)
    chunk = tcd.decode_tiles(ks["words"], ks["cfg"], 64, 64, 1, ks["prior"])
    if not torch.equal(chunk, ks["tiles"]):
        fail("K2 at the stream chunk's shape: planes differ from the tiles")
    kt["gray8 t64 chunk"] = flct_kernel_times(torch, ks)
    say("3 kernels", nvidia_smi=card, cls="gray8 chunk",
        **{k: v for k, v in kt["gray8 t64 chunk"].items() if not k.endswith("bound")})
    by_name = dict(classes)
    k5 = {f"{name} t{tile}": k0_prior_times(np, torch, dev, by_name[name], tile)
          for name, tile in K5_SHAPES}
    for cls, row in k5.items():
        say("3 k0 prior", nvidia_smi=card, cls=cls, **row)

    # The main path: each class at tile 32, and gray8 at tiles 64 and 256
    # (256x256 tiles: 48 tiles of 65,536 pixels, one K1 warp a plane and one
    # K2 thread a tile).
    tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = tcd.PRIOR_LAUNCHES = 0
    for d in ("encode", "decode"):
        graphs.REPLAYS[d] = graphs.CAPTURES[d] = 0
    blobs_by_class = {}
    runs = [(name, images, TILE) for name, images in classes]
    runs += [("gray8", classes[0][1], 64), ("gray8", classes[0][1], 256)]
    for name, images, tile in runs:
        blobs, row = flct_main_path(np, torch, dev, images, tile)
        if tile == TILE:
            blobs_by_class[name] = (images, blobs)
        say("3 main path", nvidia_smi=card, cls=name, **row)
    launches = {"encode": tcd.ENCODE_LAUNCHES, "decode": tcd.DECODE_LAUNCHES,
                "prior": tcd.PRIOR_LAUNCHES}
    main_graphs = {"replays": dict(graphs.REPLAYS), "captures": dict(graphs.CAPTURES)}
    if not (launches["encode"] and launches["decode"] and launches["prior"]):
        fail(f"the main path did not launch K1, K2 and K5: {launches}")
    if not (main_graphs["replays"]["encode"] and main_graphs["replays"]["decode"]):
        fail(f"the main path replayed no graph: {main_graphs}")
    say("3 graphs", **main_graphs)
    # Launches in one batched call of each direction (the gray8 batch).
    tc = TileConfig(TILE, TILE)
    g8 = classes[0][1]
    tcd.ENCODE_LAUNCHES = tcd.DECODE_LAUNCHES = tcd.PRIOR_LAUNCHES = 0
    g8_blobs = compress_tiled_batch(g8, tc, device=dev)
    per_call = {"encode": tcd.ENCODE_LAUNCHES, "prior": tcd.PRIOR_LAUNCHES}
    decompress_tiled_batch(g8_blobs, device=dev)
    per_call["decode"] = tcd.DECODE_LAUNCHES

    # ---- phase 4: corrupt payloads --------------------------------------
    rng = np.random.default_rng(1)
    outcomes = {}
    for name in ("gray8", "rgb8"):
        images, blobs = blobs_by_class[name]
        for i in range(min(4, len(blobs))):
            data = bytearray(blobs[i])
            hd = flct.read_tiled_header(bytes(data))
            for pos in rng.integers(hd.payload_off, len(data), 3):
                data[int(pos)] ^= 0xFF
            t0 = time.perf_counter()
            try:
                out = decompress_tiled_bytes(bytes(data), device=dev)
                outcome = "image" if out.shape == images[i].shape else "bad shape"
            except errors.DecompressionError as e:
                outcome = type(e).__name__
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if outcome == "bad shape" or secs > CORRUPT_SECONDS:
                fail(f"corrupt {name} container {i}: {outcome} in {secs:.1f}s")
            outcomes[f"{name}[{i}]"] = f"{outcome} {secs:.3f}s"
    say("4 corrupt", **outcomes)

    # ---- phase 5: the FLCS kernels against their plain versions ---------
    from felics_tpu_torch import api
    from felics_tpu_torch.config import config_for_depth
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.ops import analysis as flcs_an
    from felics_tpu_torch.ops import kscan as flcs_ks

    def lanes_of(images):
        hd = header_for_array(images[0])
        return hd, config_for_depth(hd.pixel_depth), codec._image_channels(images, hd, dev)

    def check_kscan(name, chans, h, w, cfg):
        """K3 against kscan_ref; returns the max abs error, the analysis,
        the sorted updates and the ms the plain version took."""
        a = flcs_an.analyze_channel(chans, h, w)
        su = flcs_ks.sort_updates(a.context, a.oor)
        got = flcs_ks.kscan(a.residual, su, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = flcs_ks.kscan_ref(a.residual, su, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - want).abs().max())
        if err:
            fail(f"{name}: K3 differs from its plain version (max_abs_err {err})")
        return err, a, su, plain_ms

    def check_decode(name, words, h, w, cfg, c, plains):
        """K4 against each plain version in ``plains``; returns the max abs
        error, K4's result and the seconds the plain versions took."""
        got = codec.decode_scan(words, h, w, cfg, c)
        err, t0 = 0, time.perf_counter()
        for plain in plains:
            want = plain(words, h, w, cfg, c)
            err = max([err] + [int((g.long() - r.long()).abs().max())
                               for g, r in zip(got, want)])
        if err:
            fail(f"{name}: K4 differs from its plain version (max_abs_err {err})")
        return err, got, time.perf_counter() - t0

    def words_on_card(payloads):
        return torch.from_numpy(codec.payload_words(payloads).view(np.int32)).to(dev)

    flcs_errs = {"kscan": 0, "decode": 0}
    rng5 = np.random.default_rng(5)
    halving = (rng5.integers(0, 2, (40, 40)) * 255).astype(np.uint8)
    flcs_cases = [
        ("gray8 23x17 smooth", small_image((23, 17), 255, 51, True, np)),
        ("gray8 23x17 random", small_image((23, 17), 255, 52, False, np)),
        ("gray16 16x16", small_image((16, 16), 65535, 53, True, np)),
        ("rgb8 8x6x3", small_image((8, 6, 3), 255, 54, False, np)),
        ("rgb16 8x6x3", small_image((8, 6, 3), 65535, 55, False, np)),
        ("gray8 40x40 0/255 halving", halving),
        ("gray8 1x50", small_image((1, 50), 255, 56, True, np)),
        ("gray8 50x1", small_image((50, 1), 255, 57, True, np)),
    ]
    for name, img in flcs_cases:
        hd, cfg, chans = lanes_of([img])
        h, w, c = hd.height, hd.width, hd.num_channels
        ek, _, _, _ = check_kscan(name, chans, h, w, cfg)
        payload = api.compress_image_bytes(img, device=dev)[14:]
        corrupt = bytearray(payload)
        corrupt[len(corrupt) // 2] ^= 0xFF
        ed, (planes, end, ov), _ = check_decode(
            name, words_on_card([payload, bytes(corrupt)]), h, w, cfg, c,
            (codec.decode_scan_ref, codec.decode_scan_scalar))
        if not torch.equal(planes[0].reshape(-1), chans.reshape(-1)) or bool(ov[0]):
            fail(f"{name}: K4 did not decode the stream back to its planes")
        flcs_errs["kscan"] = max(flcs_errs["kscan"], ek)
        flcs_errs["decode"] = max(flcs_errs["decode"], ed)
        say("5 flcs kernels", case=name, kscan_err=ek, decode_err=ed,
            end_bits=end.tolist(), payload_bits=len(payload) * 8,
            overrun=ov.tolist())

    # Both kernels and their plain versions timed on 4 lanes of 64x64 gray8
    # (kernel: mean of 10 launches; plain: 1 run).
    small = [small_image((64, 64), 255, 60 + i, True, np) for i in range(4)]
    hd, cfg, chans = lanes_of(small)
    e, a, su, _ = check_kscan("gray8 4x64^2", chans, 64, 64, cfg)
    words = words_on_card([b[14:] for b in api.compress_images_bytes(small, device=dev)])
    d, _, _ = check_decode("gray8 4x64^2", words, 64, 64, cfg, 1,
                           (codec.decode_scan_ref, codec.decode_scan_scalar))
    flcs_errs["kscan"], flcs_errs["decode"] = max(flcs_errs["kscan"], e), max(flcs_errs["decode"], d)
    flcs_timing = {
        "kscan": (cuda_ms(torch, lambda: flcs_ks.kscan(a.residual, su, cfg), 10),
                  cuda_ms(torch, lambda: flcs_ks.kscan_ref(a.residual, su, cfg), 1)),
        "decode": (cuda_ms(torch, lambda: codec.decode_scan(words, 64, 64, cfg, 1), 10),
                   cuda_ms(torch, lambda: codec.decode_scan_ref(words, 64, 64, cfg, 1), 1)),
    }
    say("5 flcs kernels timed", nvidia_smi=card, shape="4 lanes x 64x64 gray8",
        kscan_ms=flcs_timing["kscan"][0], kscan_plain_ms=flcs_timing["kscan"][1],
        decode_ms=flcs_timing["decode"][0], decode_plain_ms=flcs_timing["decode"][1],
        decode_scalar_ms=cuda_ms(
            torch, lambda: codec.decode_scan_scalar(words, 64, 64, cfg, 1), 1))

    # K4's k-table zeroing alone: 2 lanes of a 1x2 image decode no pixel
    # step, so the launch is the zeroing (16-bit: 8.4 MB of global scratch
    # per lane; 8-bit: 16 KB of shared memory) and the two raw words.
    zero_ms = {}
    for name, img in (("gray16", np.zeros((1, 2), np.uint16)),
                      ("gray8", np.zeros((1, 2), np.uint8))):
        hd, cfg, _ = lanes_of([img])
        wz = words_on_card([api.compress_image_bytes(img, device=dev)[14:]] * 2)
        zero_ms[name] = cuda_ms(torch, lambda: codec.decode_scan(wz, 1, 2, cfg, 1), 5)

    # A row too wide for K4's shared ring: the ring moves to global scratch.
    wide = small_image((2, 60000), 255, 58, True, np)
    hd, cfg, chans = lanes_of([wide])
    _, _, ring_shared = codec.decode_layout(
        cfg.num_k, cfg.max_context, hd.width, _build.library().flcs_decode_smem_limit())
    if ring_shared:
        fail("the 2x60000 case did not overflow K4's shared row ring")
    ek, _, _, _ = check_kscan("gray8 2x60000", chans, hd.height, hd.width, cfg)
    payload = api.compress_image_bytes(wide, device=dev)[14:]
    ed, (planes, _, ov), _ = check_decode(
        "gray8 2x60000", words_on_card([payload]), hd.height, hd.width, cfg, 1,
        (codec.decode_scan_scalar,))
    if not torch.equal(planes.reshape(-1), chans.reshape(-1)) or bool(ov[0]):
        fail("gray8 2x60000: K4 did not decode the stream back to its planes")
    flcs_errs["kscan"], flcs_errs["decode"] = max(flcs_errs["kscan"], ek), max(flcs_errs["decode"], ed)
    say("5 flcs kernels", case="gray8 2x60000 (ring in global scratch)",
        kscan_err=ek, decode_err=ed, table_zero_ms=zero_ms, nvidia_smi=card)

    # At the main path's shapes (phase 6's batches), class by class: K3
    # against kscan_ref on the whole batch; K4 against decode_scan_scalar on
    # the batch's word rows (one lane per image, as phase 6 decodes them),
    # then on one row with flipped bytes (the tensor plain version takes
    # ~3 ms a pixel on the card, the scalar one a few microseconds). Both
    # kernels timed there with CUDA events: mean of 10 warm launches (K3)
    # and of 5 (K4); each plain version over its one comparison run.
    flcs_classes = [
        ("gray8", classes[0][1][:4]),
        ("rgb8", classes[1][1][:2]),
        ("gray16", classes[2][1][:2]),
    ]
    full = {}
    for name, images in flcs_classes:
        hd, cfg, chans = lanes_of(images)
        h, w, c = hd.height, hd.width, hd.num_channels
        e, a, su, k3_plain_ms = check_kscan(f"{name} full", chans, h, w, cfg)
        k3_ms = cuda_ms(torch, lambda: flcs_ks.kscan(a.residual, su, cfg), 10)
        payloads = [b[14:] for b in api.compress_images_bytes(images, device=dev)]
        words = words_on_card(payloads)
        d, (planes, end, ov), k4_plain_s = check_decode(
            f"{name} full", words, h, w, cfg, c, (codec.decode_scan_scalar,))
        if not torch.equal(planes.reshape(chans.shape), chans) or bool(ov.any()):
            fail(f"{name}: K4 on the batch's word rows did not give its planes")
        k4_ms = cuda_ms(torch, lambda: codec.decode_scan(words, h, w, cfg, c), 5)
        corrupt = bytearray(payloads[0])
        mid = len(corrupt) // 2
        corrupt[mid : mid + 3] = bytes(b ^ 0xA5 for b in corrupt[mid : mid + 3])
        dc, (_, c_end, c_ov), _ = check_decode(
            f"{name} corrupt row", words_on_card(payloads + [bytes(corrupt)]),
            h, w, cfg, c, (codec.decode_scan_scalar,))
        flcs_errs["kscan"] = max(flcs_errs["kscan"], e)
        flcs_errs["decode"] = max(flcs_errs["decode"], d, dc)
        n_oor = int(su.num_oor.sum())
        used = int(((end + 31) // 32).sum()) * 4
        full[name] = {
            "kscan_ms": k3_ms, "kscan_plain_ms": k3_plain_ms,
            # in: each update's residual and pixel index; out: k per pixel
            "kscan_bound": bound(n_oor * 12 + chans.numel() * 4,
                                 n_oor * OPS_PER_K_ENTRY * cfg.num_k),
            "decode_ms": k4_ms, "decode_plain_ms": k4_plain_s * 1e3,
            # in: the words the streams use; out: planes, end bits, flags
            "decode_bound": bound(used + planes.numel() * 4 + len(images) * 12,
                                  OPS_PER_STEP * planes.numel()),
        }
        steps = c * (h * w - 2)
        say("5 flcs kernels at full shape", nvidia_smi=card, cls=name,
            lanes=chans.shape[0], kscan_err=e, kscan_ms=k3_ms,
            kscan_plain_ms=k3_plain_ms, kscan_bound_ms=full[name]["kscan_bound"][0],
            out_of_range_updates=n_oor,
            # pixels K4's context-0 fast path decodes
            context0_in_range_share=float(((a.context == 0) & a.in_range).float().mean()),
            segments=int(((su.rank == 0) & (torch.arange(su.rank.shape[1], device=dev)
                                             < su.num_oor[:, None])).sum()),
            longest_segment=int(su.max_rank.max()),
            kscan_us_per_longest_update=k3_ms * 1e3 / max(int(su.max_rank.max()), 1),
            decode_lanes=words.shape[0], decode_err=max(d, dc), decode_ms=k4_ms,
            decode_plain_ms=k4_plain_s * 1e3,
            decode_bound_ms=full[name]["decode_bound"][0],
            decode_us_per_step=k4_ms * 1e3 / steps,
            corrupt_row_end_bits=int(c_end[-1]), corrupt_row_overrun=bool(c_ov[-1]))

    # ---- phase 6: the FLCS main path at full size ------------------------
    flcs_ks.LAUNCHES = 0
    codec.DECODE_LAUNCHES = 0
    flcs_blobs = {}
    for name, images in flcs_classes:
        blobs = api.compress_images_bytes(images, device=dev)  # warm
        api.decompress_images_bytes(blobs, device=dev)
        enc_ms = cuda_ms(torch, lambda: api.compress_images_bytes(images, device=dev), 2)
        dec_ms = cuda_ms(torch, lambda: api.decompress_images_bytes(blobs, device=dev), 1)
        outs = api.decompress_images_bytes(blobs, device=dev)
        t0 = time.perf_counter()
        natives = [native.compress(im, header_for_array(im)) for im in images]
        t1 = time.perf_counter()
        for b in natives:
            native.decompress(b)
        t2 = time.perf_counter()
        from_native = api.decompress_images_bytes(natives, device=dev)
        for i, im in enumerate(images):
            if blobs[i] != natives[i]:
                fail(f"FLCS {name} image {i}: container differs from the native codec")
            for out, what in ((outs[i], "round trip"), (from_native[i], "native container")):
                if out.dtype != im.dtype or not np.array_equal(out, im):
                    fail(f"FLCS {name} image {i}: {what} decode is not exact")
            if api.compress_image_bytes(im, device=dev) != blobs[i]:
                fail(f"FLCS {name} image {i}: batched bytes differ from the per-image call")
        px = sum(im.shape[0] * im.shape[1] for im in images)
        raw = sum(im.nbytes for im in images)
        flcs_blobs[name] = (images, blobs)
        say("6 flcs main path", nvidia_smi=card, cls=name, images=len(images),
            shape=list(images[0].shape), encode_ms=enc_ms, decode_ms=dec_ms,
            encode_mpx_s=px / enc_ms / 1e3, decode_mpx_s=px / dec_ms / 1e3,
            ratio=raw / sum(len(b) for b in blobs),
            native_1core_encode_mpx_s=px / (t1 - t0) / 1e6,
            native_1core_decode_mpx_s=px / (t2 - t1) / 1e6,
            native_bytes_identical=True, exact_round_trip=True,
            native_containers_decoded=True, batched_equals_single=True)
    flcs_launches = {"kscan": flcs_ks.LAUNCHES, "decode": codec.DECODE_LAUNCHES}
    if not (flcs_launches["kscan"] and flcs_launches["decode"]):
        fail(f"the FLCS main path did not launch both kernels: {flcs_launches}")
    # Launches in one call of each direction (the gray8 batch).
    flcs_ks.LAUNCHES = codec.DECODE_LAUNCHES = 0
    g8_images, g8_blobs = flcs_blobs["gray8"]
    api.compress_images_bytes(g8_images, device=dev)
    flcs_per_call = {"kscan": flcs_ks.LAUNCHES}
    api.decompress_images_bytes(g8_blobs, device=dev)
    flcs_per_call["decode"] = codec.DECODE_LAUNCHES
    flct_img = classes[0][1][0]
    routed = api.compress_image_bytes(flct_img, container="flct", tile=tc, device=dev)
    if routed != tiling.compress_tiled_bytes(flct_img, tc, device=dev):
        fail("an FLCT image routed through the API differs from compress_tiled_bytes")
    if not np.array_equal(api.decompress_image_bytes(routed, device=dev), flct_img):
        fail("an FLCT image routed through the API did not round-trip")
    say("6 flct through the api", bytes_equal=True, exact_round_trip=True,
        launches=flcs_launches)

    # ---- phase 4, FLCS: corrupt payloads ---------------------------------
    outcomes = {}
    for name in ("gray8", "rgb8"):
        images, blobs = flcs_blobs[name]
        for i in range(2):
            data = bytearray(blobs[i])
            for pos in rng.integers(14, len(data), 3):
                data[int(pos)] ^= 0xFF
            t0 = time.perf_counter()
            try:
                out = api.decompress_image_bytes(bytes(data), device=dev)
                outcome = "image" if out.shape == images[i].shape else "bad shape"
            except errors.DecompressionError as e:
                outcome = type(e).__name__
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if outcome == "bad shape" or secs > CORRUPT_SECONDS:
                fail(f"corrupt FLCS {name} container {i}: {outcome} in {secs:.1f}s")
            outcomes[f"{name}[{i}]"] = f"{outcome} {secs:.3f}s"
    say("4 corrupt flcs", **outcomes)

    # ---- phase 7: the stream pair, isolation, the long row ----------------
    stream_launches = flct_stream(np, torch, dev, card, classes, blobs_by_class)
    flct_isolate(np, dev, *blobs_by_class["gray8"])
    long_row = flct_long_row(np, torch, dev, card)

    # ---- phase 8: the sharded paths and the CLIs ---------------------------
    t8 = time.perf_counter()
    meshed = sharded_mesh(np, torch, dev, card, classes, blobs_by_class)
    groups = process_groups(np, card, blobs_by_class["gray8"][1], meshed["big_single"])
    sharded = {k: meshed["launches"][k] + groups[k] for k in ("encode", "decode")}
    errs = {k: max(errs[k], meshed["errs"][k]) for k in errs}
    cli = cli_phase(np, card, classes[0][1])
    say("8 done", seconds=time.perf_counter() - t8, sharded_launches=sharded,
        mesh_launches=meshed["launches"], group_launches=groups, cli_launches=cli)

    # ---- phase 9: the host backends, the oracle against K1, K2 and K4 -------
    t9 = time.perf_counter()
    hosted = host_backends(np, torch, dev, card, classes)
    say("9 seconds", seconds=time.perf_counter() - t9)

    # ---- phase 10: the edges of the 0..20 grid through K1-K4 ---------------
    edge = edges(np, torch, dev, card)

    # ---- phase 11: the CUDA graphs of the same-shape FLCT chains ----------
    graphed = graph_phase(np, torch, dev, card, classes)

    foreign =[m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "felics_tpu")]
    if foreign:
        fail(f"modules of JAX or of the JAX package were imported: {foreign[:5]}")
    def entry(name, replaces, n_launches, per_call, err, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": "cuda",
                "source": f"felics_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                # No PyTorch call computes FELICS coding.
                "library_ms": None, "full_shape_ms": ms,
                "launches_per_call": per_call, **extra}

    flct_shape = f"gray8 12x512^2, tile {TILE}"
    g8k = kt["gray8"]

    def flct_by_class(key):
        return {cls: row[key] for cls, row in kt.items() if key in row}

    by_class = {key: {cls: full[cls][key] for cls in full}
                for key in ("kscan_ms", "decode_ms")}
    kernels = [
        entry("flct_encode", "felics_tpu/ops/pallas_codec.py:270", launches["encode"],
              per_call["encode"], errs["encode"], g8k["encode_ms"],
              g8k["encode_plain_ms"], g8k["encode_bound"], shape=flct_shape,
              full_shape_ms_by_class=flct_by_class("encode_ms"),
              kernel_only_ms_by_class=flct_by_class("encode_kernel_ms"),
              plain_ms_by_class=flct_by_class("encode_plain_ms"),
              bound_ms_by_class={c: r["encode_bound"][0] for c, r in kt.items()},
              stream_launches=stream_launches["encode"],
              sharded_launches=sharded["encode"], cli_launches=cli["encode"],
              host_backend_launches=hosted["encode"], edge_launches=edge["encode"],
              graph_replays=main_graphs["replays"]["encode"],
              graph_captures=main_graphs["captures"]["encode"],
              graph_phase_launches=graphed["encode"],
              graph_phase_replays=graphed["replays"]["encode"],
              graph_phase_captures=graphed["captures"]["encode"]),
        entry("flct_decode", "felics_tpu/ops/pallas_codec.py:805", launches["decode"],
              per_call["decode"], errs["decode"], g8k["decode_ms"],
              g8k["decode_plain_ms"], g8k["decode_bound"], shape=flct_shape,
              full_shape_ms_by_class=flct_by_class("decode_ms"),
              us_per_step_by_class=flct_by_class("decode_us_per_step"),
              slow_share_by_class=flct_by_class("decode_slow_share"),
              kernel_only_ms_by_class=flct_by_class("decode_kernel_ms"),
              plain_ms_by_class=flct_by_class("decode_plain_ms"),
              bound_ms_by_class={c: r["decode_bound"][0] for c, r in kt.items()},
              stream_launches=stream_launches["decode"],
              sharded_launches=sharded["decode"], cli_launches=cli["decode"],
              host_backend_launches=hosted["decode"], edge_launches=edge["decode"],
              graph_replays=main_graphs["replays"]["decode"],
              graph_captures=main_graphs["captures"]["decode"],
              graph_phase_launches=graphed["decode"],
              graph_phase_replays=graphed["replays"]["decode"],
              graph_phase_captures=graphed["captures"]["decode"],
              # the 64-bit-position instantiation, on the long row
              wide_launches=long_row["decode_wide_launches"],
              wide_decode_s=long_row["decode_s"], wide_kernel_ms=long_row["k2_kernel_ms"]),
        entry("flct_k0_prior", "felics_tpu/parallel/tiling.py:285 (XLA, not a TPU kernel)",
              launches["prior"], per_call["prior"], max(r["err"] for r in k5.values()),
              k5["gray8 t64"]["ms"], k5["gray8 t64"]["plain_ms"], k5["gray8 t64"]["bound"],
              shape="gray8 12x512^2, tile 64",
              full_shape_ms_by_class={c: r["ms"] for c, r in k5.items()},
              kernel_only_ms_by_class={c: r["kernel_ms"] for c, r in k5.items()},
              plain_ms_by_class={c: r["plain_ms"] for c, r in k5.items()},
              bound_ms_by_class={c: r["bound"][0] for c, r in k5.items()},
              graph_replays=main_graphs["replays"]["encode"],
              graph_captures=main_graphs["captures"]["encode"]),
        entry("flcs_kscan", "felics_tpu/ops/kscan.py:108", flcs_launches["kscan"],
              flcs_per_call["kscan"], flcs_errs["kscan"], full["gray8"]["kscan_ms"],
              full["gray8"]["kscan_plain_ms"], full["gray8"]["kscan_bound"],
              shape="gray8 4x512^2", full_shape_ms_by_class=by_class["kscan_ms"],
              bound_ms_by_class={c: r["kscan_bound"][0] for c, r in full.items()},
              small_shape="gray8 4x64^2", small_ms=flcs_timing["kscan"][0],
              small_plain_ms=flcs_timing["kscan"][1],
              sharded_launches=0, cli_launches=cli["kscan"],
              host_backend_launches=hosted["kscan"], edge_launches=edge["kscan"]),
        entry("flcs_decode", "felics_tpu/core/jax_codec.py:303", flcs_launches["decode"],
              flcs_per_call["decode"], flcs_errs["decode"], full["gray8"]["decode_ms"],
              full["gray8"]["decode_plain_ms"], full["gray8"]["decode_bound"],
              shape="gray8 4x512^2", full_shape_ms_by_class=by_class["decode_ms"],
              bound_ms_by_class={c: r["decode_bound"][0] for c, r in full.items()},
              table_zero_ms=zero_ms, small_shape="gray8 4x64^2",
              small_ms=flcs_timing["decode"][0], small_plain_ms=flcs_timing["decode"][1],
              sharded_launches=0, cli_launches=cli["flcs_decode"],
              host_backend_launches=hosted["flcs_decode"],
              edge_launches=edge["flcs_decode"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def stages() -> None:
    """FLCS stage breakdown on phase 6's batches: each stage of
    compress_images_bytes / decompress_images_bytes run alone on the card,
    synchronised after it, best of 5 on the host clock; then the device's
    idle share over one compress + decompress under torch.profiler (kernel
    entries only). One JSON line per class and measurement."""
    np, torch = need_gpu_and_repo()
    from torch.profiler import ProfilerActivity, profile

    from felics_tpu_torch import api
    from felics_tpu_torch.config import config_for_depth
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.device import to_host
    from felics_tpu_torch.format import read_header_bytes
    from felics_tpu_torch.ops import analysis, bitpack
    from felics_tpu_torch.ops import kscan as flcs_ks
    from felics_tpu_torch.ops.analysis import Symbols
    from felics_tpu_torch.ops.bits import words_to_bytes

    dev = torch.device("cuda")
    card = smi()

    def best(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), out

    classes = [
        ("gray8", synth((512, 512), np.uint8, 4, 6, np)),
        ("rgb8", synth((512, 512, 3), np.uint8, 2, 6, np)),
        ("gray16", synth((512, 512), np.uint16, 2, 800, np)),
    ]
    for name, images in classes:
        blobs = api.compress_images_bytes(images, device=dev)  # warm
        hd = api.header_for_array(images[0])
        cfg = config_for_depth(hd.pixel_depth)
        h, w, n_img = hd.height, hd.width, len(images)
        enc = {}
        enc["upload + YCoCg"], chans = best(lambda: codec._image_channels(images, hd, dev))
        enc["analyze_channel"], a = best(lambda: analysis.analyze_channel(chans, h, w))
        enc["sort_updates"], su = best(lambda: flcs_ks.sort_updates(a.context, a.oor))
        enc["kscan wrapper (segments + K3)"], k = best(
            lambda: flcs_ks.kscan(a.residual, su, cfg))
        enc["symbolize"], sym = best(lambda: analysis.symbolize(a, chans, k, h, w))
        flat = Symbols(*(f.reshape(-1) for f in sym))

        def sizes():
            off, img_bytes, total = codec._group_offsets(flat, n_img)
            return off, to_host(torch.stack([total, bitpack.count_big_symbols(flat)]))[0]

        enc["offsets + sizes copy"], (off, sz) = best(sizes)
        total_bytes, n_big = int(sz[0]), int(sz[1])
        enc["pack_bits_scatter"], words = best(
            lambda: bitpack.pack_bits_scatter(flat, off, -(-total_bytes // 4), n_big))
        enc["bytes + payload copy"], _ = best(
            lambda: to_host(words_to_bytes(words)[:total_bytes]))
        enc["sum"] = sum(enc.values())
        enc["whole call"], _ = best(lambda: api.compress_images_bytes(images, device=dev))
        print(json.dumps({"nvidia_smi": card, "cls": name, "encode_stages_ms": enc,
                          "n_big": n_big, "longest_segment": int(su.max_rank.max()),
                          "oor": su.num_oor.tolist()}), flush=True)

        dec = {}
        payloads = [b[14:] for b in blobs]
        dec["headers + payload_words (host)"], wnp = best(
            lambda: ([read_header_bytes(b) for b in blobs], codec.payload_words(payloads))[1])
        dec["upload words"], wt = best(lambda: torch.from_numpy(wnp.view(np.int32)).to(dev))
        dec["K4 decode_scan"], (planes, end, ov) = best(
            lambda: codec.decode_scan(wt, h, w, cfg, hd.num_channels), 3)
        dec["channels_to_image"], (imgs, valid) = best(
            lambda: codec._channels_to_image(planes, hd))
        dec["to_host"], host = best(lambda: to_host(end, ov, valid, imgs))
        dec["sum"] = sum(dec.values())
        dec["whole call"], _ = best(lambda: api.decompress_images_bytes(blobs, device=dev), 3)
        print(json.dumps({"nvidia_smi": card, "cls": name, "decode_stages_ms": dec}),
              flush=True)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.decompress_images_bytes(api.compress_images_bytes(images, device=dev),
                                        device=dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = device_busy_us(prof)
        print(json.dumps({"nvidia_smi": card, "cls": name,
                          "profiled_wall_ms": wall_us / 1e3,
                          "device_busy_ms": busy / 1e3,
                          "idle_share": 1 - busy / wall_us}), flush=True)


def device_busy_us(prof) -> float:
    """Microseconds in which the device ran anything: the union of the
    profiler's device spans."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (0 if cur is None else cur[1] - cur[0])


def stream_trace() -> None:
    """The FLCT stream pair beside its controls (phase 7's stream_calls) on
    phase 7's batches, each call once under torch.profiler (CPU and CUDA)
    after two warm calls: wall ms, the device's busy ms and idle share, and
    the host operations with the most time of their own. One JSON line per
    class and call."""
    np, torch = need_gpu_and_repo()
    from torch.profiler import ProfilerActivity, profile

    from felics_tpu_torch import compress_tiled_batch, compress_tiled_stream
    from felics_tpu_torch.config import TileConfig

    dev = torch.device("cuda")
    card = smi()
    tc = TileConfig(TILE, TILE)
    for name, images in flct_classes(np):
        n = STREAM_CHUNKS[name]
        chunks = [images[i : i + n] for i in range(0, len(images), n)]
        blobs = compress_tiled_batch(images, tc, device=dev)
        streamed = compress_tiled_stream(chunks, tc, depth=STREAM_DEPTH, device=dev)
        calls = stream_calls(tc, dev, images, chunks, blobs, streamed)
        for call, fn in calls.items():
            fn()
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = device_busy_us(prof)
            top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:12]
            print(json.dumps({
                "nvidia_smi": card, "cls": name, "call": call,
                "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                "idle_share": 1 - busy / wall_us,
                "top_host_self_ms": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                                     for e in top]}), flush=True)


def graphs_only() -> None:
    """Phase 11 alone (the CUDA graphs of the same-shape FLCT chains beside
    the eager chains), after the native codec's build."""
    np, torch = need_gpu_and_repo()
    subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")],
                   check=True, capture_output=True)
    counts = graph_phase(np, torch, torch.device("cuda"), smi(), flct_classes(np))
    print(json.dumps({"graph_phase": counts}), flush=True)


def flct_only() -> None:
    """FLCT alone, to compare two trees in one call: K1 and K2 timed at each
    class's batch shape (tile 32) and on gray8 at tile 64, K5 at its
    main-path shapes (K5_SHAPES; a tree without K5 fails there), then each class
    through the batched pair (checked against the native codec). One JSON
    line each. Copy this file into the other tree's root to time that tree."""
    np, torch = need_gpu_and_repo()
    dev = torch.device("cuda")
    card = smi()
    subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")],
                   check=True, capture_output=True)
    classes = flct_classes(np)
    cases = [(name, images, TILE) for name, images in classes]
    cases.append(("gray8", classes[0][1], 64))
    for name, images, tile in cases + [("gray8 chunk", classes[0][1][:K2_CHUNK], 64)]:
        row = flct_kernel_times(torch, flct_kernel_inputs(torch, dev, images, tile))
        print(json.dumps({"nvidia_smi": card, "cls": name, "kernels": row}), flush=True)
    by_name = dict(classes)
    for name, tile in K5_SHAPES:
        row = k0_prior_times(np, torch, dev, by_name[name], tile)
        print(json.dumps({"nvidia_smi": card, "cls": name, "k0_prior": row}), flush=True)
    for name, images, tile in cases:
        _, row = flct_main_path(np, torch, dev, images, tile)
        print(json.dumps({"nvidia_smi": card, "cls": name, "main_path": row}), flush=True)


def k2_library(src_dir: str, tag: str, defines=()):
    """K2 alone, from the flct_decode.cu of the tree at `src_dir`, built with
    the package's nvcc flags into a library of its own. Returns the library
    (ctypes), whether its entry takes a slow-step count, and ptxas's log."""
    import ctypes

    from felics_tpu_torch.ops import _build

    src = os.path.join(src_dir, "felics_tpu_torch", "csrc", "flct_decode.cu")
    with open(src) as f:
        counts_slow = "slow_steps" in f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "k2")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{tag}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", out, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        fail(f"nvcc of {src} failed: {r.stdout}{r.stderr}")
    lib = ctypes.CDLL(out)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flct_decode.restype = i32
    lib.flct_decode.argtypes = [
        vp, vp, i64, vp, i32, i32, i32, i32, i32, i32, i32, i32, i64, i32, i32, i32, vp,
        *([vp] if counts_slow else []), vp]
    return lib, counts_slow, r.stdout + r.stderr


def k2_launcher(torch, lib, counts_slow: bool, ks: dict):
    """A function that launches `lib`'s K2 on one shape's inputs as
    tile_codec.decode_tiles launches the package's (same tiles a block,
    rings, positions), into a fixed output; it takes an optional slow-step
    count."""
    from felics_tpu_torch.ops import _build
    from felics_tpu_torch.ops import tile_codec as tcd

    words, prior, cfg, tile = ks["words"], ks["prior"], ks["cfg"], ks["tile"]
    n, W = words.shape
    c = ks["tiles"].shape[1]
    K, nb = cfg.num_k, tcd.num_buckets(cfg)
    tpb = tcd.decode_tiles_per_block(n)
    shared = tcd.decode_smem_bytes(K, tile, tpb) <= _build.library().flcs_decode_smem_limit()
    rings = None if shared else torch.empty((-(-n // tpb), (tile + 1) * (tpb + 1)),
                                            dtype=torch.int32, device=words.device)
    stride = 0 if prior.dim() == 3 else c * nb * K
    out = torch.empty((n, c, tile * tile), dtype=torch.int32, device=words.device)

    def launch(slow=None):
        code = lib.flct_decode(
            words.data_ptr(), prior.data_ptr(), stride, out.data_ptr(), n, c, tile, tile,
            cfg.depth_bits, nb, K, int(cfg.max_context), W, tpb, int(shared),
            int(tcd.decode_wide_positions(W, c, tile, tile)),
            None if rings is None else rings.data_ptr(),
            *([None if slow is None else slow.data_ptr()] if counts_slow else []),
            torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"K2 launch failed: CUDA error {code}")
        return out

    return launch


def k2_only(other: str) -> None:
    """K2 of this tree against K2 of the tree at `other` (a git archive of
    another commit), both built alone with the same flags: exact at each
    shape (both decode the tiles K1 encoded), then timed in turns (other,
    this, this, other; K2_ROUNDS rounds, each a mean of 10 warm launches
    from CUDA events) at the batch shapes (gray8 t32 and t64, rgb8 t32,
    gray16 t32) and the serve stream's chunk, with us a step and this
    tree's slow-step share; then this tree's clock64() breakdown of a step
    at the chunk (a build with -DFLCT_DECODE_CLOCKS). One JSON line each."""
    import ctypes
    import statistics

    np, torch = need_gpu_and_repo()
    from felics_tpu_torch.ops import tile_codec as tcd

    dev = torch.device("cuda")
    card = smi()
    other = os.path.abspath(other)
    this, counts_slow, log = k2_library(REPO, "this")
    that, that_slow, _ = k2_library(other, "other")
    frames = {f: v for f, v in ptxas_frames(log).items() if "flct_decode_kernel" in f}
    if len(frames) < 8 or any(any(v) for v in frames.values()):
        fail(f"K2 ptxas (stack, spill stores, spill loads): {frames}")
    print(json.dumps({"nvidia_smi": card, "other": other,
                      "k2_ptxas": [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "stack frame" in ln]}), flush=True)
    classes = dict(flct_classes(np))
    shapes = [("gray8 t32", classes["gray8"], 32), ("gray8 t64", classes["gray8"], 64),
              ("rgb8 t32", classes["rgb8"], 32), ("gray16 t32", classes["gray16"], 32),
              ("gray8 t64 chunk", classes["gray8"][:K2_CHUNK], 64)]
    for name, images, tile in shapes:
        ks = flct_kernel_inputs(torch, dev, images, tile)
        mine = k2_launcher(torch, this, counts_slow, ks)
        theirs = k2_launcher(torch, that, that_slow, ks)
        slow = torch.zeros(1, dtype=torch.int64, device=dev)
        for side, launch in (("this", lambda: mine(slow)), ("other", theirs)):
            if not torch.equal(launch(), ks["tiles"]):
                fail(f"K2 of {side} at {name}: planes differ from the tiles")
        times = {"other": [], "this": []}
        for _ in range(K2_ROUNDS):
            for side, launch in (("other", theirs), ("this", mine), ("this", mine),
                                 ("other", theirs)):
                times[side].append(cuda_ms(torch, launch, 10))
        nt, c, t = ks["tiles"].shape
        steps = c * (t - 2)
        med = {side: statistics.median(v) for side, v in times.items()}
        print(json.dumps({
            "nvidia_smi": card, "k2": name, "tiles": nt, "planes": c, "tile": tile,
            "tpb": tcd.decode_tiles_per_block(nt), "ms": times,
            "median_ms": med, "us_per_step": {k: v * 1e3 / steps for k, v in med.items()},
            "this_over_other": med["this"] / med["other"],
            "this_won_turns": sum(a < b for a, b in zip(times["this"], times["other"])),
            "slow_share": int(slow) / (nt * steps) if counts_slow else None}), flush=True)
    # Where a step's cycles go, at the chunk: the debug build's clock64()
    # stamps (each waits for its part's result, so the parts are serialised
    # and add up to more than an uninstrumented step).
    clocked, _, _ = k2_library(REPO, "clocks", ("-DFLCT_DECODE_CLOCKS",))
    clocked.flct_decode_clocks.restype = ctypes.c_int
    clocked.flct_decode_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    sums = (ctypes.c_ulonglong * 9)()
    ks = flct_kernel_inputs(torch, dev, classes["gray8"][:K2_CHUNK], 64)
    launch = k2_launcher(torch, clocked, True, ks)
    launch()
    torch.cuda.synchronize()
    clocked.flct_decode_clocks(sums, 1)
    if not torch.equal(launch(), ks["tiles"]):
        fail("K2's clock build: planes differ from the tiles")
    torch.cuda.synchronize()
    if clocked.flct_decode_clocks(sums, 1):
        fail("K2's clock build: reading the sums failed")
    parts = ("context", "k", "bits", "run", "value", "update", "copy", "ring_loop")
    steps = sums[8]
    print(json.dumps({"nvidia_smi": card, "k2_clocks": "gray8 t64 chunk", "steps": steps,
                      "cycles_per_step": {p: sums[i] / steps for i, p in enumerate(parts)},
                      "sum": sum(sums[:8]) / steps}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--stages"]:
        stages()
    elif sys.argv[1:] == ["--flct"]:
        flct_only()
    elif sys.argv[1:] == ["--stream"]:
        stream_trace()
    elif sys.argv[1:] == ["--graphs"]:
        graphs_only()
    elif sys.argv[1:2] == ["--k2"] and len(sys.argv) == 3:
        k2_only(sys.argv[2])
    elif sys.argv[1:2] == ["--worker"]:  # a rank of phase 8's process groups
        backend, address, world, rank, out_dir = sys.argv[2:]
        group_worker(backend, address, int(world), int(rank), out_dir)
    else:
        main()

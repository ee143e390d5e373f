#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (felics_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero and prints no result:

1. card and toolchain: nvidia-smi name and power limit, torch/CUDA/nvcc
   versions, the nvcc build of felics_tpu_torch/csrc (time, ptxas usage);
2. both kernels against their plain PyTorch versions on the card, exact to
   the word, the bit count and the pixel, on small cases (gray8 with zero
   and real priors, rgb8, rgb16, gray16, odd 13x9 at tile 5x3) and on one
   noise case that makes the encoder relaunch at a wider width;
3. the main path at full size: 12x512^2 gray8, 8x512^2x3 rgb8 and 4x512^2
   gray16 (bench.py's synthetic recipe, seed 0) through
   compress_tiled_batch / decompress_tiled_batch at tile 32x32 on
   device="cuda": exact round trips, containers byte-identical to the
   native C++ FLCT codec, both kernels launched (counters), times from
   CUDA events, and each kernel against its plain version at the gray8
   batch's shapes;
4. corrupt payloads: flipped bytes in gray8 and rgb8 containers decode to
   an image of the right shape or raise felics_tpu.errors.DecompressionError,
   within a fixed time.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TILE = 32
CORRUPT_SECONDS = 60.0  # limit for one corrupt-container decode


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
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


def main() -> None:
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

    from felics_tpu import errors
    from felics_tpu.api import header_for_array
    from felics_tpu.config import TileConfig, tiled_config_for_depth
    from felics_tpu.format import PixelDepth
    from felics_tpu_torch import compress_tiled_batch, decompress_tiled_batch
    from felics_tpu_torch import decompress_tiled_bytes
    from felics_tpu_torch.ops import _build
    from felics_tpu_torch.ops import tile_codec as tcd
    from felics_tpu_torch.parallel import flct, tiling

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
    say("1 card", nvidia_smi=card, sms=props.multi_processor_count,
        torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        python=sys.version.split()[0], build_s=round(build_s, 3),
        nvcc_s=_build.BuildInfo.seconds, ptxas=ptxas)

    # ---- phase 2: kernels against their plain versions ------------------
    def both_ways(name, tiles, prior, cfg, th, tw, W):
        """Encode and decode with the kernels and the plain versions on the
        same device inputs; every output must agree exactly."""
        c = tiles.shape[1]
        wk, bk = tcd.encode_tiles(tiles, cfg, th, tw, W, prior)
        wr, br = tcd.encode_tiles_ref(tiles, cfg, th, tw, W, prior)
        enc_err = max(int((wk.long() - wr.long()).abs().max()),
                      int((bk - br).abs().max()))
        dk = tcd.decode_tiles(wk, cfg, th, tw, c, prior)
        dr = tcd.decode_tiles_ref(wk, cfg, th, tw, c, prior)
        dec_err = int((dk.long() - dr.long()).abs().max())
        rt_err = int((dk.long() - tiles.long()).abs().max())
        if enc_err or dec_err or rt_err or int(bk.max()) > 32 * W:
            fail(f"{name}: kernel vs plain enc_err={enc_err} dec_err={dec_err}"
                 f" round_trip_err={rt_err} max_bits={int(bk.max())} W={W}")
        return enc_err, dec_err

    errs = {"encode": 0, "decode": 0}
    cases = [
        ("gray8 16x16 t8 zero prior", (16, 16), 255, (8, 8), True, False),
        ("gray8 16x16 t8 prior", (16, 16), 255, (8, 8), True, True),
        ("rgb8 16x16x3 t8", (16, 16, 3), 255, (8, 8), True, True),
        ("rgb16 8x8x3 t4", (8, 8, 3), 65535, (4, 4), False, True),
        ("gray16 16x24 t8", (16, 24), 65535, (8, 8), True, True),
        ("gray8 13x9 t5x3", (13, 9), 255, (5, 3), False, True),
    ]
    for i, (name, shape, dmax, (th, tw), smooth, use_prior) in enumerate(cases):
        img = small_image(shape, dmax, 100 + i, smooth, np)
        hd = header_for_array(img)
        cfg = tiled_config_for_depth(hd.pixel_depth)
        th, tw = flct.clamped_tile_dims(hd.height, hd.width, TileConfig(th, tw))
        tiles = tiling.image_tiles(tiling.upload_image(img, dev)[None], th, tw)
        nt, c, t = tiles.shape
        if use_prior:
            _, prior = tiling.k0_prior(tiles, [nt], th, tw, cfg)
        else:
            prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k),
                                dtype=torch.int32, device=dev)
        e, d = both_ways(name, tiles, prior, cfg, th, tw,
                         tcd.encode_width_bound(cfg, t, c))
        errs["encode"], errs["decode"] = max(errs["encode"], e), max(errs["decode"], d)
        say("2 kernels", case=name, tiles=nt, enc_err=e, dec_err=d)

    # Noise on a checkerboard of dark and bright cells, under a prior that
    # holds every bucket at k = 0: each pixel costs ~230 bits, the first
    # width hint (~20 bits a pixel) is far too narrow, and encode_words must
    # relaunch wider.
    cfg8 = tiled_config_for_depth(PixelDepth.EIGHT)
    noise = checker_noise(16, 16, 7, np)
    tiles = tiling.image_tiles(tiling.upload_image(noise, dev)[None], 8, 8)
    nt, c, t = tiles.shape
    k0_bias = torch.full((c, tcd.num_buckets(cfg8), cfg8.num_k), 1 << 20,
                         dtype=torch.int32, device=dev)
    k0_bias[..., 0] = 0
    hint = tcd.width_hint(cfg8, t, c)
    before = tcd.ENCODE_LAUNCHES
    words, bits = tiling.encode_words(tiles, k0_bias, cfg8, 8, 8)
    relaunched = tcd.ENCODE_LAUNCHES - before == 2 and words.shape[1] > hint
    if not relaunched:
        fail(f"noise case did not relaunch wider (hint {hint}, W {words.shape[1]})")
    e, d = both_ways("gray8 noise k=0 prior", tiles, k0_bias, cfg8, 8, 8,
                     words.shape[1])
    wk, bk = tcd.encode_tiles(tiles, cfg8, 8, 8, words.shape[1], k0_bias)
    if not (torch.equal(wk, words) and torch.equal(bk, bits)):
        fail("relaunched encode differs from a direct launch at that width")
    say("2 kernels", case="gray8 noise relaunch", first_W=hint,
        relaunch_W=words.shape[1], max_bits=int(bits.max()), enc_err=e, dec_err=d)

    # ---- phase 3: the main path at full size ----------------------------
    subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")],
                   check=True, capture_output=True)
    from felics_tpu.native import runtime

    classes = [
        ("gray8", synth((512, 512), np.uint8, 12, 6, np)),
        ("rgb8", synth((512, 512, 3), np.uint8, 8, 6, np)),
        ("gray16", synth((512, 512), np.uint16, 4, 800, np)),
    ]
    tc = TileConfig(TILE, TILE)

    # Kernels against their plain versions at the gray8 batch's shapes, and
    # both timed on the card (kernel: mean of 10 launches; plain: 1 run).
    g8 = classes[0][1]
    tiles = torch.cat([tiling.image_tiles(tiling.upload_image(im, dev)[None],
                                          TILE, TILE) for im in g8])
    nt, c, t = tiles.shape
    _, prior = tiling.k0_prior(tiles, [nt // len(g8)] * len(g8), TILE, TILE, cfg8)
    words, bits = tiling.encode_words(tiles, prior, cfg8, TILE, TILE)
    W = words.shape[1]
    e, d = both_ways("gray8 12x512^2 t32", tiles, prior, cfg8, TILE, TILE, W)
    errs["encode"], errs["decode"] = max(errs["encode"], e), max(errs["decode"], d)
    timing = {
        "encode": (
            cuda_ms(torch, lambda: tcd.encode_tiles(tiles, cfg8, TILE, TILE, W, prior), 10),
            cuda_ms(torch, lambda: tcd.encode_tiles_ref(tiles, cfg8, TILE, TILE, W, prior), 1),
        ),
        "decode": (
            cuda_ms(torch, lambda: tcd.decode_tiles(words, cfg8, TILE, TILE, c, prior), 10),
            cuda_ms(torch, lambda: tcd.decode_tiles_ref(words, cfg8, TILE, TILE, c, prior), 1),
        ),
    }
    blocks = -(-nt // 128)
    say("3 kernels at gray8 shape", nvidia_smi=card, tiles=nt, W=W,
        threads=nt, blocks_of_128=blocks, sms=props.multi_processor_count,
        enc_err=e, dec_err=d,
        encode_ms=timing["encode"][0], encode_plain_ms=timing["encode"][1],
        decode_ms=timing["decode"][0], decode_plain_ms=timing["decode"][1])

    tcd.ENCODE_LAUNCHES = 0
    tcd.DECODE_LAUNCHES = 0
    blobs_by_class = {}
    for name, images in classes:
        blobs = compress_tiled_batch(images, tc, device=dev)  # warm
        decompress_tiled_batch(blobs, device=dev)
        reps = 3
        enc_ms = cuda_ms(torch, lambda: compress_tiled_batch(images, tc, device=dev), reps)
        dec_ms = cuda_ms(torch, lambda: decompress_tiled_batch(blobs, device=dev), reps)
        outs = decompress_tiled_batch(blobs, device=dev)
        for i, (im, out) in enumerate(zip(images, outs)):
            if out.dtype != im.dtype or not np.array_equal(out, im):
                fail(f"{name} image {i}: round trip is not exact")
            native = runtime.compress_tiled(im, header_for_array(im), TILE, TILE)
            if blobs[i] != native:
                fail(f"{name} image {i}: container differs from the native codec")
        px = sum(im.shape[0] * im.shape[1] for im in images)
        raw = sum(im.nbytes for im in images)
        blobs_by_class[name] = (images, blobs)
        say("3 main path", nvidia_smi=card, cls=name, images=len(images),
            shape=list(images[0].shape), tile=TILE,
            encode_ms=enc_ms, decode_ms=dec_ms,
            encode_mpx_s=px / enc_ms / 1e3, decode_mpx_s=px / dec_ms / 1e3,
            combined_mpx_s=2 * px / (enc_ms + dec_ms) / 1e3,
            ratio=raw / sum(len(b) for b in blobs),
            exact_round_trip=True, native_bytes_identical=True)
    launches = {"encode": tcd.ENCODE_LAUNCHES, "decode": tcd.DECODE_LAUNCHES}
    if not (launches["encode"] and launches["decode"]):
        fail(f"the main path did not launch both kernels: {launches}")

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

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    kernels = [
        {"name": "flct_encode", "route": "cuda",
         "source": "felics_tpu_torch/csrc/flct_encode.cu",
         "replaces": "felics_tpu/ops/pallas_codec.py:270",
         "launches": launches["encode"], "max_abs_err": errs["encode"],
         "ms": timing["encode"][0], "plain_ms": timing["encode"][1]},
        {"name": "flct_decode", "route": "cuda",
         "source": "felics_tpu_torch/csrc/flct_decode.cu",
         "replaces": "felics_tpu/ops/pallas_codec.py:805",
         "launches": launches["decode"], "max_abs_err": errs["decode"],
         "ms": timing["decode"][0], "plain_ms": timing["decode"][1]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

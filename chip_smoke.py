#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (felics_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --stages   # FLCS stage breakdown and idle share

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
4. corrupt payloads: flipped bytes in gray8 and rgb8 containers, FLCT and
   (after phase 6) FLCS, decode to an image of the right shape or raise
   felics_tpu.errors.DecompressionError, within a fixed time;
5. the FLCS kernels against their plain PyTorch versions on the card,
   exact: per-pixel k of the k scan (K3), and planes, end bit and overrun
   flag of the decoder (K4), on small gray8/gray16/rgb8/rgb16 cases, the
   0/255 halving image, 1x50 and 50x1, K4 against both its plain versions
   (tensor ops, and Python ints lane by lane); both kernels timed beside
   their plain versions on 4 lanes of 64x64 gray8; then at the main path's
   full shapes (phase 6's batches): K3 against its plain version, K4
   against the scalar plain version on the batch's word rows plus one
   row with flipped bytes;
6. the FLCS main path at full size through felics_tpu_torch.api on
   device="cuda": 4x512^2 gray8, 2x512^2x3 rgb8 and 2x512^2 gray16 through
   compress_images_bytes / decompress_images_bytes: containers
   byte-identical to the native C++ codec, native containers decoding
   exactly, exact round trips, batched bytes equal to the per-image call,
   one FLCT image routed through the API, K3 and K4 launched (counters),
   times from CUDA events beside the native codec on one host core.

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

    from felics_tpu import errors
    from felics_tpu.api import header_for_array
    from felics_tpu.config import TileConfig, tiled_config_for_depth
    from felics_tpu.format import PixelDepth
    from felics_tpu_torch import compress_tiled_batch, decompress_tiled_batch
    from felics_tpu_torch import decompress_tiled_bytes
    from felics_tpu_torch.device import upload_image
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
        tiles = tiling.image_tiles(upload_image(img, dev)[None], th, tw)
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
    tiles = tiling.image_tiles(upload_image(noise, dev)[None], 8, 8)
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
    tiles = torch.cat([tiling.image_tiles(upload_image(im, dev)[None],
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

    # ---- phase 5: the FLCS kernels against their plain versions ---------
    from felics_tpu.config import config_for_depth
    from felics_tpu_torch import api
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.ops import analysis as flcs_an
    from felics_tpu_torch.ops import kscan as flcs_ks

    def lanes_of(images):
        hd = header_for_array(images[0])
        return hd, config_for_depth(hd.pixel_depth), codec._image_channels(images, hd, dev)

    def check_kscan(name, chans, h, w, cfg):
        a = flcs_an.analyze_channel(chans, h, w)
        su = flcs_ks.sort_updates(a.context, a.oor)
        got = flcs_ks.kscan(a.residual, su, cfg)
        want = flcs_ks.kscan_ref(a.residual, su, cfg)
        err = int((got.long() - want).abs().max())
        if err:
            fail(f"{name}: K3 differs from its plain version (max_abs_err {err})")
        return err, a, su

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
        ek, _, _ = check_kscan(name, chans, h, w, cfg)
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
    e, a, su = check_kscan("gray8 4x64^2", chans, 64, 64, cfg)
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

    # At the main path's shapes, class by class: K3 against kscan_ref on the
    # whole batch; K4 against decode_scan_scalar on the batch's word rows and
    # one row with flipped bytes (the tensor plain version takes ~3 ms a
    # pixel on the card, the scalar one a few microseconds).
    flcs_classes = [
        ("gray8", classes[0][1][:4]),
        ("rgb8", classes[1][1][:2]),
        ("gray16", classes[2][1][:2]),
    ]
    for name, images in flcs_classes:
        hd, cfg, chans = lanes_of(images)
        h, w, c = hd.height, hd.width, hd.num_channels
        t0 = time.perf_counter()
        e, a, su = check_kscan(f"{name} full", chans, h, w, cfg)
        k3_compare_s = time.perf_counter() - t0
        k3_ms = cuda_ms(torch, lambda: flcs_ks.kscan(a.residual, su, cfg), 10)
        payloads = [b[14:] for b in api.compress_images_bytes(images, device=dev)]
        corrupt = bytearray(payloads[0])
        mid = len(corrupt) // 2
        corrupt[mid : mid + 3] = bytes(b ^ 0xA5 for b in corrupt[mid : mid + 3])
        words = words_on_card(payloads + [bytes(corrupt)])
        d, (planes, end, ov), k4_compare_s = check_decode(
            f"{name} full", words, h, w, cfg, c, (codec.decode_scan_scalar,))
        if not torch.equal(planes[: len(images)].reshape(chans.shape), chans):
            fail(f"{name}: K4 on the batch's word rows did not give its planes")
        flcs_errs["kscan"], flcs_errs["decode"] = max(flcs_errs["kscan"], e), max(flcs_errs["decode"], d)
        say("5 flcs kernels at full shape", nvidia_smi=card, cls=name,
            lanes=chans.shape[0], kscan_err=e, kscan_ms=k3_ms,
            kscan_plain_compare_s=k3_compare_s,
            segments=int(((su.rank == 0) & (torch.arange(su.rank.shape[1], device=dev)
                                             < su.num_oor[:, None])).sum()),
            longest_segment=int(su.max_rank.max()), decode_lanes=words.shape[0],
            decode_err=d, decode_scalar_compare_s=k4_compare_s,
            corrupt_row_end_bits=int(end[-1]), corrupt_row_overrun=bool(ov[-1]))

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
        natives = [runtime.compress(im, header_for_array(im)) for im in images]
        t1 = time.perf_counter()
        for b in natives:
            runtime.decompress(b, header_for_array(images[0]))
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
        {"name": "flcs_kscan", "route": "cuda",
         "source": "felics_tpu_torch/csrc/flcs_kscan.cu",
         "replaces": "felics_tpu/ops/kscan.py:108",
         "launches": flcs_launches["kscan"], "max_abs_err": flcs_errs["kscan"],
         "ms": flcs_timing["kscan"][0], "plain_ms": flcs_timing["kscan"][1]},
        {"name": "flcs_decode", "route": "cuda",
         "source": "felics_tpu_torch/csrc/flcs_decode.cu",
         "replaces": "felics_tpu/core/jax_codec.py:303",
         "launches": flcs_launches["decode"], "max_abs_err": flcs_errs["decode"],
         "ms": flcs_timing["decode"][0], "plain_ms": flcs_timing["decode"][1]},
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

    from felics_tpu.config import config_for_depth
    from felics_tpu.format import read_header_bytes
    from felics_tpu_torch import api
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.device import to_host
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
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type.name == "CUDA")
        busy, cur = 0.0, None
        for s, e in spans:  # union of the device spans
            if cur is None or s > cur[1]:
                busy += 0 if cur is None else cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        busy += 0 if cur is None else cur[1] - cur[0]
        print(json.dumps({"nvidia_smi": card, "cls": name,
                          "profiled_wall_ms": wall_us / 1e3,
                          "device_busy_ms": busy / 1e3,
                          "idle_share": 1 - busy / wall_us}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--stages"]:
        stages()
    else:
        main()

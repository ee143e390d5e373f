"""FLCS single-stream codec on one device, both directions.

Counterpart: felics_tpu/core/jax_codec.py. The container is bit-exact with
the reference codec: the FLCS header, then every channel's codewords as one
continuous bitstream per image (Y, Co, Cg for RGB) with a single byte
alignment at the end.

Encode, per group of same-shape images (lanes = every channel of every
image, image-major then channel-major): upload, YCoCg on the device,
analysis, the adaptive-k scan (kernel K3 on CUDA), symbols, per-image
byte-aligned offsets, the bit packer, one device-to-host copy of the sizes
and one of the payload. Degenerate dims (fewer than two pixels) carry raw
32-bit words only, written and read on the host.

Decode, per group of same-shape containers (lanes = images): one upload of
the zero-padded word rows, the per-pixel scan (kernel K4 on CUDA, one
block per image, one thread of it walking the pixels), inverse YCoCg and
range flags on the device, one device-to-host copy. A lane whose cursor
ends past its payload, or whose unary run ran off the words, raises
``errors.IoError``; a value outside the depth raises
``errors.InvalidValue``.

Every function takes ``device``; a CUDA tensor gets the kernel or an
exception, never the plain version.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import CodingConfig, config_for_depth
from felics_tpu_torch.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu_torch.core.context import neighbour_indices
from felics_tpu_torch.device import resolve_device, to_host, upload_image
from felics_tpu_torch.format import (
    HEADER_SIZE, ColorType, Header, PixelDepth, header_bytes, header_for_array,
    read_header_bytes,
)
from felics_tpu_torch.ops import _build, bitpack
from felics_tpu_torch.ops.analysis import (
    PHASE_IN_BITS, Symbols, analyze_channel, symbolize,
)
from felics_tpu_torch.ops.bits import (
    MASK32, bit_length, k_select, shl32, shr32, to_u32_value, words_to_bytes,
    wrap32,
)
from felics_tpu_torch.ops.kscan import check_cfg, compute_k

# Kernel launches made by ``decode_scan`` (plain-version calls are not
# counted). Callers reset it to 0 to see what a run launched.
DECODE_LAUNCHES = 0

_DTYPES = {PixelDepth.EIGHT: np.uint8, PixelDepth.SIXTEEN: np.uint16}


def _degenerate(header: Header) -> bool:
    return header.height * header.width < 2


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _image_channels(
    images: Sequence[np.ndarray], header: Header, device: torch.device
) -> torch.Tensor:
    """Same-shape images -> (N*C, H*W) int32 channel lanes on ``device``,
    image-major then channel-major (Y, Co, Cg for RGB)."""
    x = upload_image(np.stack(images), device)
    n_img, n = len(images), header.height * header.width
    if header.color_type == ColorType.GRAY:
        return x.reshape(n_img, n)
    y, co, cg = rgb_to_ycocg(x[..., 0], x[..., 1], x[..., 2], xp=torch)
    return torch.stack([y, co, cg], dim=1).reshape(n_img * 3, n)


def _group_offsets(symbols: Symbols, n_imgs: int):
    """Bit offsets of a flat stream of ``n_imgs`` images' symbols where each
    image starts on a byte boundary; returns (offsets, bytes per image,
    total bytes) as tensors."""
    lens = symbols.total_len.reshape(n_imgs, -1)
    ends = torch.cumsum(lens, dim=1)
    img_bytes = (ends[:, -1] + 7) >> 3
    img_starts = torch.cumsum(img_bytes, dim=0) - img_bytes
    offsets = (img_starts.unsqueeze(1) << 3) + ends - lens
    return offsets.reshape(-1), img_bytes, img_bytes.sum()


def _pack_group(symbols: Symbols, n_imgs: int) -> List[bytes]:
    """One payload per image: offsets, one copy of the sizes, the packer and
    one copy of the payload, split at the images' byte boundaries."""
    flat = Symbols(*(f.reshape(-1) for f in symbols))
    offsets, img_bytes, total = _group_offsets(flat, n_imgs)
    sizes, img_np = to_host(
        torch.stack([total, bitpack.count_big_symbols(flat)]), img_bytes
    )
    total_bytes, n_big = int(sizes[0]), int(sizes[1])
    words = bitpack.pack_bits_scatter(flat, offsets, -(-total_bytes // 4), n_big)
    payload = to_host(words_to_bytes(words)[:total_bytes])[0].tobytes()
    pos = np.concatenate([[0], np.cumsum(img_np)])
    return [payload[pos[i] : pos[i + 1]] for i in range(n_imgs)]


def _encode_group(
    chans: torch.Tensor, n_imgs: int, height: int, width: int,
    cfg: CodingConfig,
) -> List[bytes]:
    analysis = analyze_channel(chans, height, width)
    k = compute_k(analysis.context, analysis.oor, analysis.residual, cfg)
    return _pack_group(symbolize(analysis, chans, k, height, width), n_imgs)


def encode_payload(
    channels: torch.Tensor, height: int, width: int, cfg: CodingConfig
) -> bytes:
    """(C, H*W) int32 channel planes of one image, on its device -> the
    byte-aligned FLCS payload."""
    if height * width < 2:
        return _raw_payload(channels)
    return _encode_group(channels, 1, height, width, cfg)[0]


def _raw_payload(channels: torch.Tensor) -> bytes:
    """Payload of an image of fewer than 2 pixels: per channel, its pixel
    (0 for a zero-area image) and a 0, as raw signed 32-bit big-endian
    words (reference: src/compression.rs:92-103)."""
    first = channels[:, :1].cpu().numpy()
    words = np.zeros((channels.shape[0], 2), ">i4")
    words[:, : first.shape[1]] = first
    return words.tobytes()


def _decode_raw(data: bytes, header: Header) -> np.ndarray:
    """Image of a container of fewer than 2 pixels: each channel's two
    raw words, of which the first is the pixel of a 1x1 image."""
    c, n = header.num_channels, header.height * header.width
    if len(data) - HEADER_SIZE < 8 * c:
        raise errors.IoError("unexpected end of bitstream")
    raw = np.frombuffer(data, ">i4", count=2 * c, offset=HEADER_SIZE).reshape(c, 2)
    planes = torch.from_numpy(raw[:, :n].astype(np.int32))[None]
    img, valid = _channels_to_image(planes, header)
    if not bool(valid[0]):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return img[0].numpy().astype(_DTYPES[header.pixel_depth])


def compress_image_bytes(
    image: np.ndarray, header: Header, device="cuda"
) -> bytes:
    """One (H, W[, 3]) uint8/uint16 image -> FLCS container bytes."""
    chans = _image_channels([np.asarray(image)], header, resolve_device(device))
    return header_bytes(header) + encode_payload(
        chans, header.height, header.width, config_for_depth(header.pixel_depth)
    )


def compress_images_bytes(
    images: Sequence[np.ndarray], device="cuda"
) -> List[bytes]:
    """FLCS containers of a batch, each equal to ``compress_image_bytes`` of
    that image alone; same-shape images share one device pass."""
    dev = resolve_device(device)
    headers = [header_for_array(im) for im in images]
    results: List[bytes] = [b""] * len(images)
    groups: Dict[Tuple, List[int]] = {}
    for idx, (im, hd) in enumerate(zip(images, headers)):
        if _degenerate(hd):
            results[idx] = compress_image_bytes(im, hd, dev)
            continue
        key = (hd.height, hd.width, hd.color_type, hd.pixel_depth)
        groups.setdefault(key, []).append(idx)
    for (h, w, _color, depth), idx in groups.items():
        hd = headers[idx[0]]
        chans = _image_channels([np.asarray(images[i]) for i in idx], hd, dev)
        payloads = _encode_group(chans, len(idx), h, w, config_for_depth(depth))
        for i, payload in zip(idx, payloads):
            results[i] = header_bytes(headers[i]) + payload
    return results


# ---------------------------------------------------------------------------
# Decode: kernel K4 and its plain version
# ---------------------------------------------------------------------------


def _check_decode(words: torch.Tensor, height: int, width: int, channels: int):
    if words.dim() != 2 or words.dtype != torch.int32 or words.shape[1] < 1:
        raise ValueError("words must be a (G, W) int32 tensor with W >= 1")
    if height * width < 2:
        raise ValueError("the scan decodes planes of >= 2 pixels")
    if channels not in (1, 3):
        raise ValueError(f"images have 1 or 3 channels; got {channels}")


def decode_scan_ref(
    words: torch.Tensor, height: int, width: int, cfg: CodingConfig,
    channels: int,
):
    """Plain version of K4: every lane's C channels decoded through one bit
    cursor, pixel by pixel with all lanes at once. Returns ((G, C, H*W)
    int32 planes, (G,) int64 end bit, (G,) bool overrun)."""
    _check_decode(words, height, width, channels)
    K = check_cfg(cfg)
    G, W = words.shape
    dev = words.device
    n = height * width
    u = to_u32_value(words)
    lanes = torch.arange(G, device=dev)
    ks = torch.arange(K, device=dev)
    limit = 32 * W
    max_ctx = int(cfg.max_context)
    a_idx, b_idx = neighbour_indices(height, width)

    def peek32(pos):
        # An index past the words reads the last word, as the reference's
        # gather does.
        wi = pos >> 5
        w0 = u[lanes, wi.clamp(max=W - 1)]
        w1 = u[lanes, (wi + 1).clamp(max=W - 1)]
        return shl32(w0, pos & 31) | shr32(w1, 32 - (pos & 31))

    def bit(pos):
        return peek32(pos) >> 31

    out = torch.zeros((G, channels, n), dtype=torch.int64, device=dev)
    pos = torch.zeros(G, dtype=torch.int64, device=dev)
    overrun = torch.zeros(G, dtype=torch.bool, device=dev)
    for c in range(channels):
        plane = out[:, c]
        table = torch.zeros((G, max_ctx + 1, K), dtype=torch.int64, device=dev)
        plane[:, 0] = wrap32(peek32(pos))
        plane[:, 1] = wrap32(peek32(pos + 32))
        pos = pos + 64
        for i in range(2, n):
            va, vb = plane[:, int(a_idx[i])], plane[:, int(b_idx[i])]
            h, l = torch.maximum(va, vb), torch.minimum(va, vb)
            ctx = wrap32(h - l).clamp(0, max_ctx)
            is_in = bit(pos) == 1

            # In range: phase-in over nn = ctx + 1.
            nn = ctx + 1
            m = bit_length(nn, PHASE_IN_BITS) - 1
            one = torch.ones_like(nn)
            left, right = nn - (one << m), (one << (m + 1)) - nn
            fm = torch.where(m > 0, shr32(peek32(pos + 1), 32 - m), 0)
            short = fm < right
            number = torch.where(
                short, fm, (fm - right) * 2 + right + bit(pos + 1 + m)
            )
            in_value = wrap32((number + left) % nn + l)
            in_pos = pos + 1 + torch.where(short, m, m + 1)

            # Out of range: sign bit, unary run (stops at 32*W), k bits.
            row = table[lanes, ctx]
            k = k_select(row, ks)
            above = bit(pos + 1) == 1
            q = torch.zeros_like(pos)
            p = pos + 2
            active = ~is_in
            while bool(active.any()):
                lead = 32 - bit_length((~peek32(p)) & MASK32, 32)
                fin = (lead < 32) | (p >= limit)
                overrun |= active & (lead == 32) & fin
                q = torch.where(active, q + lead, q)
                p = torch.where(active, p + lead + (fin & (lead < 32)).long(), p)
                active &= ~fin
            rem = torch.where(k > 0, shr32(peek32(p), 32 - k), 0)
            encoded = wrap32((q << k) + rem)
            oor_value = torch.where(
                above, wrap32(encoded + h + 1), wrap32(l - encoded - 1)
            )
            new_row = wrap32(row + (encoded.unsqueeze(1) >> ks) + 1 + ks)
            if cfg.count_scaling is not None:
                halve = new_row.min(dim=1, keepdim=True).values > cfg.count_scaling
                new_row = torch.where(halve, new_row >> 1, new_row)
            table[lanes, ctx] = torch.where(is_in.unsqueeze(1), row, new_row)
            plane[:, i] = torch.where(is_in, in_value, oor_value)
            pos = torch.where(is_in, in_pos, p + k)
    return out.to(torch.int32), pos, overrun


def decode_scan_scalar(
    words: torch.Tensor, height: int, width: int, cfg: CodingConfig,
    channels: int,
):
    """``decode_scan_ref`` lane by lane with Python ints: the same int32
    wrap-around, clamped word reads and overrun rule, at a few microseconds
    a pixel instead of dozens of tensor launches, so K4 can be held to a
    plain version at full image size. Same arguments and results."""
    _check_decode(words, height, width, channels)
    K = check_cfg(cfg)
    G, W = words.shape
    n = height * width
    limit = 32 * W
    max_ctx = int(cfg.max_context)
    scale = cfg.count_scaling
    a_idx, b_idx = (i.tolist() for i in neighbour_indices(height, width))
    out = np.zeros((G, channels, n), np.int32)
    ends, overruns = [0] * G, [False] * G
    for g, row in enumerate(to_u32_value(words).tolist()):
        # Reading past the words gives the last word again, as the
        # reference's clamped gather does: pairs[j] holds words j and j+1.
        pairs = [(row[j] << 32) | row[min(j + 1, W - 1)] for j in range(W)]

        def peek32(pos):
            return (pairs[min(pos >> 5, W - 1)] >> (32 - (pos & 31))) & MASK32

        pos, overrun = 0, False
        for c in range(channels):
            plane = [0] * n
            table = {}
            plane[0] = _wrap(peek32(pos))
            plane[1] = _wrap(peek32(pos + 32))
            pos += 64
            for i in range(2, n):
                va, vb = plane[a_idx[i]], plane[b_idx[i]]
                h, l = (va, vb) if va > vb else (vb, va)
                ctx = min(max(_wrap(h - l), 0), max_ctx)
                head = peek32(pos)
                if head >> 31:  # in range: phase-in over ctx + 1
                    nn = ctx + 1
                    m = nn.bit_length() - 1
                    left, right = nn - (1 << m), (2 << m) - nn
                    fm = peek32(pos + 1) >> (32 - m) if m else 0
                    if fm < right:
                        number, pos = fm, pos + 1 + m
                    else:
                        number = (fm - right) * 2 + right + (peek32(pos + 1 + m) >> 31)
                        pos += 2 + m
                    plane[i] = _wrap((number + left) % nn + l)
                    continue
                # Out of range: sign bit, unary run (stops at 32*W), k bits.
                trow = table.get(ctx) or [0] * K
                least = min(trow)
                k = K - 1 - trow[::-1].index(least)  # ties to the largest k
                q, p = 0, pos + 2
                while True:
                    lead = 32 - ((~peek32(p)) & MASK32).bit_length()
                    if lead < 32:
                        q, p = q + lead, p + lead + 1
                        break
                    q += 32
                    if p >= limit:
                        overrun, p = True, p + 32
                        break
                    p += 32
                rem = peek32(p) >> (32 - k) if k else 0
                encoded = _wrap((q << k) + rem)
                if (head >> 30) & 1:
                    plane[i] = _wrap(encoded + h + 1)
                else:
                    plane[i] = _wrap(l - encoded - 1)
                trow = [_wrap(v + (encoded >> j) + 1 + j) for j, v in enumerate(trow)]
                if scale is not None and min(trow) > scale:
                    trow = [v >> 1 for v in trow]
                table[ctx] = trow
                pos = p + k
            out[g, c] = plane
        ends[g], overruns[g] = pos, overrun
    dev = words.device
    return (
        torch.from_numpy(out).to(dev),
        torch.tensor(ends, dtype=torch.int64, device=dev),
        torch.tensor(overruns, dtype=torch.bool, device=dev),
    )


def _wrap(v: int) -> int:
    """Python int reduced to int32 two's complement (``bits.wrap32``)."""
    return ((v + (1 << 31)) & MASK32) - (1 << 31)


# A k-table of at most this many bytes sits in shared memory in K4
# (the 8-bit one, 16,352 bytes); a larger one (16-bit, 8.4 MB) in global
# scratch.
TABLE_SMEM_MAX = 48 * 1024


def decode_layout(K: int, max_context: int, width: int, smem_limit: int):
    """Where K4 keeps its state: (k-table row stride, table in shared
    memory, row ring in shared memory), for a block that may opt in to
    ``smem_limit`` bytes of dynamic shared memory. The ring of the row
    above holds width + 1 int32 and takes what the table leaves."""
    rs = 8 if K <= 8 else 16
    table_bytes = (max_context + 1) * rs * 4
    table_shared = table_bytes <= TABLE_SMEM_MAX
    ring_bytes = (width + 1) * 4
    ring_shared = (table_bytes if table_shared else 0) + ring_bytes <= smem_limit
    return rs, table_shared, ring_shared


def decode_scan(
    words: torch.Tensor, height: int, width: int, cfg: CodingConfig,
    channels: int,
):
    """Decode (G, W) int32 word rows (uint32 bit patterns, one image a row)
    into ((G, C, H*W) int32 planes, (G,) int64 end bit, (G,) bool overrun).
    CUDA tensors launch flcs_decode.cu; CPU tensors run
    ``decode_scan_ref``."""
    global DECODE_LAUNCHES
    _check_decode(words, height, width, channels)
    K = check_cfg(cfg)
    if words.device.type == "cpu":
        return decode_scan_ref(words, height, width, cfg, channels)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    _build.check_kernel_k(K)
    G, W = words.shape
    dev = words.device
    words = words.contiguous()
    out = torch.empty((G, channels, height * width), dtype=torch.int32, device=dev)
    end = torch.empty(G, dtype=torch.int64, device=dev)
    overrun = torch.empty(G, dtype=torch.int32, device=dev)
    if G == 0:
        return out, end, overrun.bool()
    max_ctx = int(cfg.max_context)
    cs = -1 if cfg.count_scaling is None else int(cfg.count_scaling)
    lib = _build.library()
    with torch.cuda.device(dev):
        limit = lib.flcs_decode_smem_limit()
        if limit < 0:
            raise RuntimeError("flcs_decode: cannot read the shared memory limit")
        rs, table_shared, ring_shared = decode_layout(K, max_ctx, width, limit)
        tables = None if table_shared else torch.empty(
            (G, (max_ctx + 1) * rs), dtype=torch.int32, device=dev)
        rings = None if ring_shared else torch.empty(
            (G, width + 1), dtype=torch.int32, device=dev)
        code = lib.flcs_decode(
            words.data_ptr(), W, G, channels, height, width, K, max_ctx, cs,
            rs, int(table_shared), None if tables is None else tables.data_ptr(),
            int(ring_shared), None if rings is None else rings.data_ptr(),
            out.data_ptr(), end.data_ptr(), overrun.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "flcs_decode")
    DECODE_LAUNCHES += 1
    return out, end, overrun.bool()


# ---------------------------------------------------------------------------
# Decode: containers
# ---------------------------------------------------------------------------


def payload_words(payloads: Sequence[bytes]) -> np.ndarray:
    """Payloads -> (N, W) uint32 big-endian word rows, zero past each
    payload, W = the longest payload's word count (at least 1)."""
    wl = max([-(-len(p) // 4) for p in payloads] + [1])
    buf = np.zeros((len(payloads), wl * 4), np.uint8)
    for i, p in enumerate(payloads):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
    return buf.view(">u4").astype(np.uint32)


def _channels_to_image(planes: torch.Tensor, header: Header):
    """(N, C, H*W) int32 planes -> ((N, H, W[, 3]) pixels narrowed for the
    copy, (N,) bool: every value fits the depth)."""
    N = planes.shape[0]
    bound = (1 << header.pixel_depth.bits) - 1
    shape = (N, header.height, header.width)
    if header.color_type == ColorType.GRAY:
        out = planes[:, 0].reshape(shape)
    else:
        r, g, b = ycocg_to_rgb(planes[:, 0], planes[:, 1], planes[:, 2], xp=torch)
        out = torch.stack([r, g, b], dim=-1).reshape(shape + (3,))
    valid = ((out >= 0) & (out <= bound)).reshape(N, -1).all(dim=1)
    narrow = torch.uint8 if header.pixel_depth == PixelDepth.EIGHT else torch.int32
    return out.clamp(0, bound).to(narrow), valid


def _decode_group(members, device: torch.device) -> List:
    """Images (or the DecompressionError instance) of same-shape containers:
    one upload, one scan, device assembly and one device-to-host copy."""
    hd = members[0][1]
    cfg = config_for_depth(hd.pixel_depth)
    payloads = [p for _i, _hd, p in members]
    words = torch.from_numpy(payload_words(payloads).view(np.int32)).to(device)
    planes, end, overrun = decode_scan(
        words, hd.height, hd.width, cfg, hd.num_channels
    )
    imgs, valid = _channels_to_image(planes, hd)
    end_np, ov_np, valid_np, imgs_np = to_host(end, overrun, valid, imgs)
    out: List = []
    for m, payload in enumerate(payloads):
        # Reference: src/compression.rs:205-244 returns an error on a read
        # past the stream; the overrun flag catches a word-aligned payload
        # whose unary runaway ends exactly on its last bit.
        if ov_np[m] or int(end_np[m]) > len(payload) * 8:
            out.append(errors.IoError("FLCS payload ended prematurely"))
        elif not valid_np[m]:
            out.append(errors.InvalidValue("decoded value does not fit the pixel depth"))
        else:
            out.append(imgs_np[m].astype(_DTYPES[hd.pixel_depth]))
    return out


def decompress_images_bytes(
    datas: Sequence[bytes], on_error: str = "raise", device="cuda"
) -> List:
    """Images of FLCS containers; same-shape containers decode as one scan
    with one lane per image. ``on_error="raise"``: any corrupt member
    raises its DecompressionError. ``on_error="isolate"``: the list holds
    the image of each good member and the error instance of each bad one."""
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    isolate = on_error == "isolate"
    dev = resolve_device(device)
    results: List = [None] * len(datas)
    groups: Dict[Tuple, List] = {}
    for idx, data in enumerate(datas):
        try:
            header = read_header_bytes(data)
            if _degenerate(header):
                results[idx] = _decode_raw(data, header)
                continue
        except errors.DecompressionError as e:
            if not isolate:
                raise
            results[idx] = e
            continue
        key = (header.height, header.width, header.color_type, header.pixel_depth)
        groups.setdefault(key, []).append((idx, header, data[HEADER_SIZE:]))
    for members in groups.values():
        for (idx, _hd, _p), res in zip(members, _decode_group(members, dev)):
            if isinstance(res, errors.DecompressionError) and not isolate:
                raise res
            results[idx] = res
    return results


def decompress_image_bytes(data: bytes, device="cuda") -> np.ndarray:
    """FLCS container bytes -> (H, W[, 3]) uint8/uint16 image."""
    return decompress_images_bytes([data], device=device)[0]

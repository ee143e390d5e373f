"""Seeded photograph-like images: the one generator every traffic mix reads.

An image is a smooth field with a power spectrum of about 1/f^alpha
(white noise filtered in the Fourier domain), hard-edged regions laid over
it (ellipses and rectangles, each shifting the level by a constant), small
independent sensor noise, and quantisation to the depth. RGB images share
one luminance field; two weaker chroma fields (and the regions' colour
casts) make the channels differ, so that YCoCg-R pays as it does on
photographs. The same seed on the same device gives the same images.

Work is done on ``device`` (the card in a run) in a few large calls per
image size, then copied to the host as the arrays the code under test is
given.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

ALPHA = 2.0          # power spectrum ~ 1/f^alpha
CUTOFF = 0.11        # optics: the spectrum rolls off as exp(-(f/cutoff)^2), cycles/pixel
FIELD_STD = 40.0     # std of the smooth luminance field, in 8-bit levels
REGIONS = 12         # hard-edged regions per image
REGION_SHIFT = 40.0  # largest level shift of a region, 8-bit levels
NOISE_STD = 2.0      # sensor noise, 8-bit levels
CHROMA = 0.3         # chroma fields' std as a share of the luminance field's


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` for any whole ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def smooth_fields(n: int, h: int, w: int, alpha: float, cutoff: float, g,
                  device) -> torch.Tensor:
    """(n, h, w) float32 fields of unit std with power ~ 1/f^alpha, rolled
    off past ``cutoff`` as a lens does."""
    noise = torch.randn((n, h, w), generator=g, device=device)
    fy = torch.fft.fftfreq(h, device=device).reshape(h, 1)
    fx = torch.fft.rfftfreq(w, device=device).reshape(1, -1)
    f = torch.sqrt(fy * fy + fx * fx)
    amp = torch.where(f > 0, f.clamp(min=1.0 / max(h, w)) ** (-alpha / 2), 0.0)
    amp = amp * torch.exp(-(f / cutoff) ** 2)
    field = torch.fft.irfft2(torch.fft.rfft2(noise) * amp, s=(h, w))
    field = field - field.mean(dim=(1, 2), keepdim=True)
    return field / field.std(dim=(1, 2), keepdim=True).clamp(min=1e-6)


def region_shifts(n: int, h: int, w: int, count: int, shift: float, channels: int,
                  g, device) -> torch.Tensor:
    """(n, channels, h, w) float32 level shifts of ``count`` hard-edged
    regions per image, later regions over earlier ones."""
    yy = torch.arange(h, device=device, dtype=torch.float32).reshape(1, h, 1) / h
    xx = torch.arange(w, device=device, dtype=torch.float32).reshape(1, 1, w) / w
    out = torch.zeros((n, channels, h, w), device=device)
    for _ in range(count):
        cy, cx, ry, rx, kind = torch.rand((5, n, 1, 1), generator=g, device=device)
        ry, rx = 0.05 + 0.3 * ry, 0.05 + 0.3 * rx
        dy, dx = (yy - cy) / ry, (xx - cx) / rx
        ellipse = dy * dy + dx * dx <= 1.0
        box = (dy.abs() <= 1.0) & (dx.abs() <= 1.0)
        inside = torch.where(kind < 0.5, ellipse, box)  # (n, h, w)
        level = (torch.rand((n, 1, 1, 1), generator=g, device=device) * 2 - 1) * shift
        cast = 1 + 0.3 * (torch.rand((n, channels, 1, 1), generator=g, device=device) * 2 - 1)
        out = torch.where(inside.unsqueeze(1), level * cast, out)
    return out


def make_images(n: int, h: int, w: int, rgb: bool, depth: int, g, device) -> np.ndarray:
    """(n, h, w[, 3]) uint8/uint16 photograph-like images."""
    scale = ((1 << depth) - 1) / 255.0
    c = 3 if rgb else 1
    luma = smooth_fields(n, h, w, ALPHA, CUTOFF, g, device) * FIELD_STD
    x = luma.unsqueeze(1).expand(n, c, h, w)
    if rgb:
        cr, cb = (smooth_fields(n, h, w, ALPHA, CUTOFF, g, device) * FIELD_STD * CHROMA
                  for _ in range(2))
        x = x + torch.stack([cr, -(cr + cb) / 2, cb], dim=1)
    x = x + region_shifts(n, h, w, REGIONS, REGION_SHIFT, c, g, device)
    x = x + torch.randn((n, c, h, w), generator=g, device=device) * NOISE_STD
    x = (x * scale + (1 << (depth - 1))).round().clamp(0, (1 << depth) - 1)
    x = x.permute(0, 2, 3, 1) if rgb else x[:, 0]
    dtype = np.uint8 if depth == 8 else np.uint16
    return x.to(torch.int32).cpu().numpy().astype(dtype)


def make_pool(seed: int, sizes: Sequence[Tuple[int, int]], counts: Sequence[int],
              rgb: bool, depth: int, device) -> List[np.ndarray]:
    """``counts[i]`` images of ``sizes[i]`` each, in that order, from one
    seed."""
    g = generator(seed, device)
    pool: List[np.ndarray] = []
    for (h, w), n in zip(sizes, counts):
        pool.extend(make_images(n, h, w, rgb, depth, g, device))
    return pool

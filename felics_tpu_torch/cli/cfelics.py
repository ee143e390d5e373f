"""cfelics — compress an image file to a felics file.

Counterpart: felics_tpu/cli/cfelics.py. The same ``-i/--input``
``-o/--output`` flags, per-depth progress message and exit code 1 with a
printed message on unreadable or unsupported inputs; ``--container flct``
and ``--tile-size`` as there. ``--backend`` is ``device`` (default: the
port's codecs on ``--device``), ``oracle`` or ``native``, as in
``felics_tpu_torch.api``; the reference's ``auto`` has no counterpart.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cfelics", description="Compresses an image file to a felics file"
    )
    parser.add_argument("-i", "--input", required=True, help="The input file.")
    parser.add_argument(
        "-o", "--output", required=True, help="The output felics file."
    )
    parser.add_argument(
        "--container",
        choices=["flcs", "flct"],
        default="flcs",
        help="flcs = reference-compatible single stream; flct = tiled format.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device to code on: cuda (default), cuda:N or cpu.",
    )
    parser.add_argument(
        "--backend", choices=["device", "oracle", "native"], default="device",
        help="Codec: device (on --device), oracle (scalar, FLCS) or native (C++).",
    )
    parser.add_argument(
        "--tile-size", type=int, default=128, help="FLCT tile side length."
    )
    args = parser.parse_args(argv)

    from felics_tpu_torch.io.images import UnsupportedImageFormat, load_image

    try:
        image = load_image(args.input)
    except FileNotFoundError as e:
        print(f"Cannot open file: {e}")
        return 1
    except UnsupportedImageFormat as e:
        print(f"Unsupported image format: {e}")
        return 1
    except Exception as e:
        print(f"Cannot decode image: {e}")
        return 1

    depth = 8 if image.dtype.itemsize == 1 else 16
    kind = "grayscale" if image.ndim == 2 else "rgb"
    print(f"Compressing {depth}-bit {kind} image...")

    from felics_tpu_torch.api import compress_image_bytes
    from felics_tpu_torch.config import TileConfig

    try:
        data = compress_image_bytes(
            image,
            container=args.container,
            tile=TileConfig(tile_h=args.tile_size, tile_w=args.tile_size),
            device=args.device,
            backend=args.backend,
        )
        with open(args.output, "wb") as f:
            f.write(data)
    except Exception as e:
        print(f"Cannot compress image: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

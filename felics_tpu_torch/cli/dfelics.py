"""dfelics — decompress a felics file to another image file.

Counterpart: felics_tpu/cli/dfelics.py. ``-i/--input`` ``-o/--output``;
the output format follows the output extension. FLCS and FLCT containers
alike; ``--backend`` ``device`` (default, on ``--device``), ``oracle`` or
``native``, as in ``felics_tpu_torch.api``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dfelics",
        description="Decompresses a felics file to another image file",
    )
    parser.add_argument("-i", "--input", required=True, help="The input felics file.")
    parser.add_argument(
        "-o",
        "--output",
        required=True,
        help="The output file; format chosen by its extension.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device to decode on: cuda (default), cuda:N or cpu.",
    )
    parser.add_argument(
        "--backend", choices=["device", "oracle", "native"], default="device",
        help="Codec: device (on --device), oracle (scalar, FLCS) or native (C++).",
    )
    args = parser.parse_args(argv)

    try:
        with open(args.input, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"Cannot open input file: {e}")
        return 1

    from felics_tpu_torch.api import decompress_image_bytes

    try:
        image = decompress_image_bytes(
            data, device=args.device, backend=args.backend)
    except Exception as e:
        print(f"Error while decompressing the image: {e!r}")
        return 1

    from felics_tpu_torch.io.images import save_image

    try:
        save_image(args.output, image)
    except Exception as e:
        print(f"Cannot save image: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""vfelics — visualize a felics file.

Counterpart: felics_tpu/cli/vfelics.py. Decodes, prints the image info, and
shows it through PIL's viewer when a display is available; otherwise (or
with ``--export``) writes a PNG. ``--device`` picks where it decodes.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vfelics", description="Visualizes a felics file"
    )
    parser.add_argument("input", help="The path to the felics file.")
    parser.add_argument(
        "--export", help="Write a PNG here instead of opening a window."
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device to decode on: cuda (default), cuda:N or cpu.",
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
        image = decompress_image_bytes(data, device=args.device)
    except Exception as e:
        print(f"Error while decompressing the image: {e!r}")
        return 1

    name = os.path.basename(args.input)
    h, w = image.shape[:2]
    kind = "grayscale" if image.ndim == 2 else "rgb"
    print(f"{name}: {w}x{h} {image.dtype} {kind}")

    from felics_tpu_torch.io.images import save_image

    if args.export:
        save_image(args.export, image)
        print(f"Wrote {args.export}")
        return 0

    if os.environ.get("DISPLAY") or sys.platform == "darwin":
        from PIL import Image

        arr8 = image if image.dtype.itemsize == 1 else (image >> 8).astype("uint8")
        Image.fromarray(arr8).show(title=name)
    else:
        out = os.path.splitext(args.input)[0] + ".png"
        save_image(out, image)
        print(f"No display available; wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

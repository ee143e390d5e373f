"""bfelics — cross-format corpus benchmark.

Counterpart: felics_tpu/cli/bfelics.py. Converts every TIFF in a corpus
directory to .fel through ``felics_tpu_torch.api`` (``--backend`` on
``--device``), to PNG through PIL, to QOI through the native core's codec
(``felics_tpu_torch.native``), to lossless JPEG 2000 through PIL, and to
WebP when ``cwebp`` is on the path; times each pass and its decompression,
and prints total sizes and ratios; ``--plot`` renders the bar charts.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _corpus_files(src: str):
    return sorted(
        f for f in os.listdir(src) if f.lower().endswith((".tiff", ".tif"))
    )


def _dir_bytes(path: str) -> int:
    return sum(
        os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
    )


def bench_felics(files, src, out_dir, container, device, tile_size, backend="device"):
    from felics_tpu_torch.api import compress_image_bytes
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.io.images import load_image

    os.makedirs(out_dir, exist_ok=True)
    start = time.time()
    for name in files:
        image = load_image(os.path.join(src, name))
        data = compress_image_bytes(
            image,
            container=container,
            tile=TileConfig(tile_h=tile_size, tile_w=tile_size),
            device=device,
            backend=backend,
        )
        with open(
            os.path.join(out_dir, os.path.splitext(name)[0] + ".fel"), "wb"
        ) as f:
            f.write(data)
    return time.time() - start, _dir_bytes(out_dir)


def bench_png(files, src, out_dir):
    from felics_tpu_torch.io.images import load_image, save_image

    os.makedirs(out_dir, exist_ok=True)
    start = time.time()
    for name in files:
        image = load_image(os.path.join(src, name))
        save_image(os.path.join(out_dir, os.path.splitext(name)[0] + ".png"), image)
    return time.time() - start, _dir_bytes(out_dir)


def bench_external(files, src, out_dir, tool, make_cmd):
    if shutil.which(tool) is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    start = time.time()
    for name in files:
        subprocess.run(
            make_cmd(os.path.join(src, name), out_dir, os.path.splitext(name)[0]),
            check=False,
            capture_output=True,
        )
    return time.time() - start, _dir_bytes(out_dir)


def bench_qoi(files, src, out_dir):
    """The QOI column, from the native core's codec. QOI is 8-bit RGB/RGBA
    only: gray expands to RGB, and a 16-bit corpus gets no column."""
    import numpy as np

    from felics_tpu_torch import native
    from felics_tpu_torch.io.images import load_image

    if not native.qoi_available():
        return None
    os.makedirs(out_dir, exist_ok=True)
    start = time.time()
    for name in files:
        image = load_image(os.path.join(src, name))
        if image.dtype != np.uint8:
            return None
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        data = native.qoi_encode(image)
        with open(
            os.path.join(out_dir, os.path.splitext(name)[0] + ".qoi"), "wb"
        ) as f:
            f.write(data)
    return time.time() - start, _dir_bytes(out_dir)


def bench_jp2(files, src, out_dir):
    """Lossless JPEG 2000 column (PIL's OpenJPEG binding, reversible 5/3
    wavelet); None when the codec is missing or an image cannot be
    encoded."""
    from PIL import Image, features

    from felics_tpu_torch.io.images import load_image

    if not features.check("jpg_2000"):
        return None
    os.makedirs(out_dir, exist_ok=True)
    start = time.time()
    for name in files:
        image = load_image(os.path.join(src, name))
        dst = os.path.join(out_dir, os.path.splitext(name)[0] + ".jp2")
        try:
            Image.fromarray(image).save(dst, format="JPEG2000", irreversible=False)
        except Exception:
            return None
    return time.time() - start, _dir_bytes(out_dir)


def bench_jp2_decompress(out_dir):
    import numpy as np
    from PIL import Image

    files = [f for f in os.listdir(out_dir) if f.endswith(".jp2")]
    start = time.time()
    for name in files:
        np.asarray(Image.open(os.path.join(out_dir, name)))
    return time.time() - start


def bench_qoi_decompress(out_dir):
    from felics_tpu_torch import native

    files = [f for f in os.listdir(out_dir) if f.endswith(".qoi")]
    start = time.time()
    for name in files:
        with open(os.path.join(out_dir, name), "rb") as f:
            native.qoi_decode(f.read())
    return time.time() - start


def bench_felics_decompress(out_dir, device, backend="device"):
    from felics_tpu_torch.api import decompress_image_bytes

    files = [f for f in os.listdir(out_dir) if f.endswith(".fel")]
    start = time.time()
    for name in files:
        with open(os.path.join(out_dir, name), "rb") as f:
            decompress_image_bytes(f.read(), device=device, backend=backend)
    return time.time() - start


def bench_png_decompress(out_dir):
    from felics_tpu_torch.io.images import load_image

    files = [f for f in os.listdir(out_dir) if f.endswith(".png")]
    start = time.time()
    for name in files:
        load_image(os.path.join(out_dir, name))
    return time.time() - start


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bfelics", description="Cross-format corpus benchmark"
    )
    parser.add_argument("--corpus", required=True, help="Directory of TIFFs.")
    parser.add_argument(
        "--out", default=os.path.join(tempfile.gettempdir(), "bfelics"),
        help="Output root.",
    )
    parser.add_argument("--container", choices=["flcs", "flct"], default="flcs")
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device for the .fel columns: cuda (default), cuda:N or cpu.",
    )
    parser.add_argument(
        "--backend", choices=["device", "oracle", "native"], default="device",
        help="Codec of the .fel columns: device, oracle or native.",
    )
    parser.add_argument("--tile-size", type=int, default=128)
    parser.add_argument("--plot", action="store_true", help="Write bar charts.")
    args = parser.parse_args(argv)

    files = _corpus_files(args.corpus)
    if not files:
        print(f"No TIFFs found in {args.corpus}")
        return 1
    print(f"Benchmarking {len(files)} images from {args.corpus}")

    results = {}
    t, size = bench_felics(
        files, args.corpus, os.path.join(args.out, "to_felics"),
        args.container, args.device, args.tile_size, args.backend,
    )
    results[".fel"] = (t, size)
    t, size = bench_png(files, args.corpus, os.path.join(args.out, "to_png"))
    results[".png"] = (t, size)
    webp = bench_external(
        files, args.corpus, os.path.join(args.out, "to_webp"), "cwebp",
        lambda inp, outd, stem: [
            "cwebp", "-lossless", inp, "-o", os.path.join(outd, stem + ".webp")
        ],
    )
    if webp:
        results[".webp"] = webp
    qoi = bench_qoi(files, args.corpus, os.path.join(args.out, "to_qoi"))
    if qoi:
        results[".qoi"] = qoi
    jp2 = bench_jp2(files, args.corpus, os.path.join(args.out, "to_jp2"))
    if jp2:
        results[".jp2"] = jp2

    dec_times = {
        ".fel": bench_felics_decompress(
            os.path.join(args.out, "to_felics"), args.device, args.backend
        ),
        ".png": bench_png_decompress(os.path.join(args.out, "to_png")),
    }
    if qoi:
        dec_times[".qoi"] = bench_qoi_decompress(os.path.join(args.out, "to_qoi"))
    if jp2:
        dec_times[".jp2"] = bench_jp2_decompress(os.path.join(args.out, "to_jp2"))

    raw = sum(
        os.path.getsize(os.path.join(args.corpus, f)) for f in files
    )
    print(f"\nRaw corpus size: {raw / 1e6:.1f} MB")
    for fmt, (t, size) in results.items():
        dec = f"  dec {dec_times[fmt]:6.2f}s" if fmt in dec_times else ""
        print(
            f"{fmt:>6}: enc {t:7.2f}s  {size / 1e6:8.2f} MB  "
            f"ratio {raw / size:5.2f}{dec}"
        )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fmts = list(results)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ax1.bar(fmts, [results[f][0] for f in fmts])
        ax1.set_ylabel("Compression elapsed time (seconds)")
        ax2.bar(fmts, [results[f][1] / 1e6 for f in fmts])
        ax2.set_ylabel("Size (MB)")
        out = os.path.join(args.out, "benchmark.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

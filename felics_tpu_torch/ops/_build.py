"""Build the CUDA sources in ``felics_tpu_torch/csrc`` at first use.

nvcc compiles each ``csrc/*.cu`` for ``sm_90a`` in a process of its own, all
started together, and links the objects into one shared library with a
plain C interface, which ``ctypes`` loads. The library lands in
``felics_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is downloaded; a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = (
    "flct_encode.cu", "flct_decode.cu", "flct_k0_prior.cu", "flcs_kscan.cu",
    "flcs_decode.cu",
)
HEADERS = ("flct_common.cuh", "flcs_common.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# The k counts the kernels are compiled for: the shipped 8-bit and 16-bit
# configs.
KERNEL_K = (6, 15)
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers, local memory and spills
)


class BuildInfo:
    """What the last build or load did: the library path, the seconds the
    build took (0.0 when a built library was reused) and nvcc's output."""

    path: Optional[Path] = None
    seconds: Optional[float] = None
    log: str = ""


_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")  # the toolkit's default
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from felics_tpu_torch/csrc at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for this exact source hash is
    already built; returns its path."""
    out = BUILD_DIR / f"libflct_{_source_hash()}.so"
    if out.exists():
        BuildInfo.path, BuildInfo.seconds = out, 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        jobs = []
        for src in SOURCES:
            obj = os.path.join(work, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        # Wait for every compile before judging any, so none outlives us.
        logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
        for cmd, log, code in logs:
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{log}")
        lib = os.path.join(work, "lib.so")
        link = [nvcc, *ARCH, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        seconds = time.perf_counter() - t0
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    BuildInfo.path, BuildInfo.seconds = out, seconds
    BuildInfo.log = "".join(log for _, log, _ in logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flct_encode.restype = i32
        lib.flct_encode.argtypes = [
            vp, vp, i64, vp, vp, i32, i32, i32, i32, i32, i32, i32, i64, vp,
        ]
        lib.flct_decode.restype = i32
        lib.flct_decode.argtypes = [
            vp, vp, i64, vp, i32, i32, i32, i32, i32, i32, i32, i32, i64, i32,
            i32, i32, vp, vp, vp,
        ]
        lib.flct_k0_prior.restype = i32
        lib.flct_k0_prior.argtypes = [
            vp, vp, i64, vp, vp, vp, i64, i64, i32, i32, i32, i32, i32, i32, vp,
        ]
        lib.flcs_kscan.restype = i32
        lib.flcs_kscan.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32, vp]
        lib.flcs_decode.restype = i32
        lib.flcs_decode.argtypes = [
            vp, i64, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp, i32, vp,
            vp, vp, vp, vp,
        ]
        lib.flcs_decode_smem_limit.restype = i32
        lib.flcs_decode_smem_limit.argtypes = []
        lib.flct_error_string.restype = ctypes.c_char_p
        lib.flct_error_string.argtypes = [i32]
        _lib = lib
    return _lib


def check_kernel_k(K: int) -> None:
    if K not in KERNEL_K:
        raise ValueError(f"the CUDA kernels take K in {KERNEL_K}; got {K}")


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().flct_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} ({msg})")

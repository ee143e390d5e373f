"""The port's multi-process FLCT (felics_tpu_torch.parallel.multihost) on
``torch.distributed`` with gloo, mirroring tests/test_multihost.py: two
processes, each this file run as a script, join one group on the CPU and
encode the same image (and a corpus) with their tiles sharded over the two
ranks, then decode it; the bytes of both ranks must equal each other and
felics_tpu's one-process ``compress_tiled_bytes`` /
``compress_tiled_batch(..., "xla")``, and the decodes must be exact. One
world-size-1 group also runs in the pytest process. Tolerance zero.

This module imports no JAX when it is run as a script (the workers) or
imported; the tests import felics_tpu inside their bodies.
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _image():
    rng = np.random.default_rng(7)
    return np.clip(
        np.cumsum(np.cumsum(rng.integers(-6, 7, (64, 48)), 0), 1) + 128, 0, 255
    ).astype(np.uint8)


def _corpus():
    rng = np.random.default_rng(9)
    return [
        np.clip(
            np.cumsum(np.cumsum(rng.integers(-6, 7, (48, 32)), 0), 1) + 128, 0, 255,
        ).astype(np.uint8)
        for _ in range(3)
    ]


def _tile():
    from felics_tpu_torch.config import TileConfig

    return TileConfig(16, 16)


def _run(out_dir: str, rank: int) -> None:
    """One rank's work: the image, its decode and the corpus, written to
    ``out_dir`` under the rank's name."""
    from felics_tpu_torch.parallel import multihost
    from felics_tpu_torch.ops import tile_codec

    img = _image()
    data = multihost.encode_tiled_multihost(img, _tile(), device="cpu")
    out = multihost.decode_tiled_multihost(data, device="cpu")
    blobs = multihost.encode_corpus_multihost(_corpus(), _tile(), device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.fel"), "wb") as f:
        f.write(data)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out)
    for i, b in enumerate(blobs):
        with open(os.path.join(out_dir, f"rank{rank}_corpus{i}.fel"), "wb") as f:
            f.write(b)
    print("launches", tile_codec.ENCODE_LAUNCHES, tile_codec.DECODE_LAUNCHES, flush=True)


def _worker(coordinator: str, world: int, rank: int, out_dir: str) -> int:
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from felics_tpu_torch.parallel import multihost

    multihost.init_process(coordinator, world, rank, backend="gloo")
    multihost.init_process(coordinator, world, rank, backend="gloo")  # idempotent
    assert multihost.global_tile_mesh("cpu").world == world
    _run(out_dir, rank)
    torch.distributed.destroy_process_group()
    return 0


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _check_against_reference(blob: bytes, out: np.ndarray, corpus_blobs) -> None:
    from felics_tpu.config import TileConfig
    from felics_tpu.parallel import batch, tiling

    img = _image()
    assert blob == tiling.compress_tiled_bytes(img, TileConfig(16, 16)), (
        "multi-process bytes diverge from single-process")
    assert out.dtype == img.dtype and np.array_equal(out, img)
    assert list(corpus_blobs) == batch.compress_tiled_batch(
        _corpus(), TileConfig(16, 16), "xla"), "corpus bytes diverge from the batch API"


def test_two_process_gloo_matches_single_process(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator, "2", str(i),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"
        # Each rank launched its own encode and decode (plain versions on
        # the CPU do not count as launches).
        assert "launches 0 0" in logs[i]

    blobs = [_read(tmp_path / f"rank{i}.fel") for i in range(2)]
    assert blobs[0] == blobs[1], "processes disagree on container bytes"
    outs = [np.load(tmp_path / f"rank{i}.npy") for i in range(2)]
    assert np.array_equal(outs[0], outs[1])
    corpora = [[_read(tmp_path / f"rank{r}_corpus{i}.fel") for i in range(3)]
               for r in range(2)]
    assert corpora[0] == corpora[1]
    _check_against_reference(blobs[0], outs[0], corpora[0])


def test_world_size_one_in_process(tmp_path):
    import pytest
    import torch.distributed as dist

    from felics_tpu_torch import compress_tiled_bytes, errors
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.parallel import flct, multihost, tiling

    assert not dist.is_initialized()
    multihost.init_process(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    try:
        pm = multihost.global_tile_mesh("cpu")
        assert (pm.rank, pm.world, pm.backend) == (0, 1, "gloo")
        assert str(pm.device) == "cpu"
        img = _image()[:20, :36]  # 2x3 tiles, clamped at the bottom
        data = multihost.encode_tiled_multihost(img, _tile(), device="cpu")
        assert data == compress_tiled_bytes(img, _tile(), device="cpu")
        assert np.array_equal(multihost.decode_tiled_multihost(data, device="cpu"), img)
        # A value outside the depth, found on the rank's planes after the
        # gather, raises as the one-device decode does.
        rgb8 = np.random.default_rng(1234).integers(100, 150, (8, 12, 3)).astype(np.uint8)
        flipped = bytearray(compress_tiled_bytes(rgb8, TileConfig(4, 4), device="cpu"))
        hd = flct.read_tiled_header(bytes(flipped))
        for i in range(hd.payload_off, hd.payload_off + int(hd.tile_lengths[0])):
            flipped[i] ^= 0xFF
        for decode in (tiling.decompress_tiled_bytes, multihost.decode_tiled_multihost):
            with pytest.raises(errors.InvalidValue):
                decode(bytes(flipped), device="cpu")
        empty = np.zeros((3, 0), np.uint8)
        assert multihost.encode_corpus_multihost([empty], _tile(), device="cpu") == [
            compress_tiled_bytes(empty, _tile(), device="cpu")]
        try:
            multihost.init_process("127.0.0.1:1", 2, 1, backend="gloo")
        except RuntimeError as e:
            assert "already in process group" in str(e)
        else:
            raise AssertionError("a second group was joined")
    finally:
        dist.destroy_process_group()


def test_rank_device(monkeypatch):
    """A bare "cuda" puts each rank on its own card: the local rank (from
    LOCAL_RANK, else the group rank) modulo the card count; a named card or
    the CPU is kept."""
    import torch

    from felics_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert multihost.rank_device("cuda", 0) == torch.device("cuda", 0)
    assert multihost.rank_device("cuda", 5) == torch.device("cuda", 1)
    assert multihost.rank_device("cuda:3", 5) == torch.device("cuda", 3)
    assert multihost.rank_device("cpu", 5) == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert multihost.rank_device("cuda", 5) == torch.device("cuda", 2)


def test_without_a_group_raises():
    import pytest

    from felics_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="init_process"):
        multihost.encode_tiled_multihost(_image(), _tile(), device="cpu")


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))

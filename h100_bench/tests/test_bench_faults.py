"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: the whole run (set-up, window, trace, check) on the
CPU at a tiny size, the card's check skipped. Faults a cell of this
benchmark can have: an answer altered where it is produced, half of a
batch left out. The controls (each container's ``control``) fail too."""

import time

import numpy as np
import pytest

from conftest import PAIRS, pair_cell, tiny
from h100_bench import check, harness
from h100_bench.reference import controls


def run(name, cpu, substitute=None):
    cell = tiny(pair_cell(name))
    res, checks = harness.run_cell(cell, 2**31 + 11, 0.2, False, cpu, time.perf_counter(),
                                   substitute=substitute)
    line = harness.report(cell, False, res, checks, cpu)
    return line, checks


@pytest.mark.parametrize("name", PAIRS)
def test_sound_run_is_correct(name, cpu):
    line, checks = run(name, cpu)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert checks["images_compared"]["value"] > 0
    assert all(c["value"] == 0 for k, c in checks.items() if c["limit"] is not None)


@pytest.mark.parametrize("name", PAIRS)
def test_control_is_not_correct(name, cpu):
    cell = tiny(pair_cell(name))
    direction = harness.load_file(
        harness.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py").DIRECTION
    line, checks = run(name, cpu, harness.load_container(cell.config).control(
        direction, cell.config, cpu))
    assert not line["correct"]
    key = "bad_containers" if direction == "encode" else "bad_samples"
    assert checks[key]["value"] > checks[key]["limit"]


def flip_a_payload_byte(monkeypatch):
    from felics_tpu_torch.parallel import tiling

    real = tiling.pack_containers

    def altered(*args, **kw):
        out = real(*args, **kw)
        return [b[:-1] + bytes([b[-1] ^ 1]) for b in out]
    monkeypatch.setattr(tiling, "pack_containers", altered)


def alter_a_pixel(monkeypatch):
    from felics_tpu_torch.parallel import tiling

    real = tiling.decode_finish

    def altered(p):
        imgs, ok = real(p)
        for im in imgs:
            im.reshape(-1)[0] ^= 1
        return imgs, ok
    monkeypatch.setattr(tiling, "decode_finish", altered)


def drop_half_encoded(monkeypatch):
    from felics_tpu_torch.parallel import batch

    real = batch._encode_finish
    monkeypatch.setattr(batch, "_encode_finish", lambda s: real(s)[: max(1, len(s[0]) // 2)])


def drop_half_decoded(monkeypatch):
    from felics_tpu_torch.parallel import batch

    real = batch._decode_finish
    monkeypatch.setattr(batch, "_decode_finish",
                        lambda s, *a: real(s, *a)[: max(1, len(s[0]) // 2)])


@pytest.mark.parametrize("fault", [flip_a_payload_byte, drop_half_encoded])
@pytest.mark.parametrize("name", [c for c in PAIRS if "ingest" in c])
def test_broken_encode_is_not_correct(name, fault, cpu, monkeypatch):
    fault(monkeypatch)
    line, checks = run(name, cpu)
    assert not line["correct"] and checks["bad_containers"]["value"] > 0


@pytest.mark.parametrize("fault", [alter_a_pixel, drop_half_decoded])
@pytest.mark.parametrize("name", [c for c in PAIRS if "serve" in c])
def test_broken_decode_is_not_correct(name, fault, cpu, monkeypatch):
    fault(monkeypatch)
    line, checks = run(name, cpu)
    assert not line["correct"] and checks["bad_samples"]["value"] > 0


def test_a_call_that_raises_counts_as_failed(cpu):
    calls = []

    def boom(driver, items):  # sound through set-up's two passes, then raises
        calls.append(items)
        if len(calls) > 4:
            raise RuntimeError("broken entry point")
        return controls.v0_encode([driver.pool[i] for i in items], (8, 8), cpu)
    line, checks = run("gray8-t64.ingest-b12", cpu, boom)
    assert not line["correct"] and line["failed"] == line["attempted"] > 0
    assert check.correct(checks) is False
    assert "broken entry point" in line["errors"][0]


def test_check_lines_name_each_number_and_limit():
    checks = {"images_compared": {"value": 3, "limit": None},
              "bad_containers": {"value": 0, "limit": 0}}
    assert check.lines(checks)[-1] == "check bad_containers 0 limit 0"
    assert check.correct(checks)
    checks["bad_containers"]["value"] = 1
    assert not check.correct(checks)
    assert np.isscalar(checks["images_compared"]["value"])

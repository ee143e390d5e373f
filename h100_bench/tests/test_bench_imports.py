"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and nothing of the code under test in the reference."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "felics_tpu"}


def loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_port_or_jax():
    mods = loaded_after("from h100_bench import check, harness, roofline\n"
                        "from h100_bench.reference import flcs_ref, flct_ref, controls\n"
                        "from h100_bench.traffic import images\n"
                        "for name in ('flct', 'flcs'):\n"
                        "    harness.load_container({'container': name})")
    assert not mods & (FORBIDDEN | {"felics_tpu_torch"})


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'h100_bench/tests')\n"
        "from conftest import tiny\n"
        "from h100_bench import harness\n"
        "cell = tiny(harness.load_cell('gray8-t64.serve-stream-4x3'))\n"
        "res, checks = harness.run_cell(cell, 5, 0.2, True, torch.device('cpu'), time.perf_counter())\n"
        "assert harness.check.correct(checks) if hasattr(harness, 'check') else True\n"
        "for name in ('drivers', 'metrics'):\n"
        "    import pathlib\n"
        "    for p in pathlib.Path('h100_bench', name).glob('*.py'):\n"
        "        harness.load_file(p)\n"
    )
    mods = loaded_after(code)
    assert "felics_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    from h100_bench import harness

    for name in ("jaxtyping", "felics_tpu_torch", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]

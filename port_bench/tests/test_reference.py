"""The plain reference is shown right against the port's CPU path at a
tiny size, and neither a run nor the reference loads what it must not."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import harness, spec

DATA = Path(__file__).resolve().parent / "data"
ROOT = Path(__file__).resolve().parents[2]


def run_cell(name, seed=2 ** 31 + 11, **kw):
    cell = spec.load_cell(name, root=DATA, here=DATA)
    run = spec.kind_runner(cell.traffic["kind"])
    seconds = 0.0 if cell.traffic["kind"] == "train" else 1.0
    return cell, run(cell, seed, seconds, False, torch.device("cpu"),
                     log=lambda *a: None, **kw)


# the port's CPU path runs its plain versions; all in fp32 the reference
# (grid_sample for the gathers, its own AdamW loop) differs by rounding
@pytest.mark.parametrize("name", ["tiny_m2f_fp32_train",
                                  "tiny_upernet_fp32_train",
                                  "tiny_m2f_fp32_infer"])
def test_reference_follows_the_port_on_the_cpu(name):
    cell, r = run_cell(name)
    assert r["failed"] == 0
    for k, v in r["numbers"].items():
        assert v <= cell.limits[k], (k, v)


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _modules_after(
        "import port_bench.harness, port_bench.readings\n"
        "import vitadapter_torch.train.loop, vitadapter_torch.builder\n"
        "import vitadapter_torch.train.trainer, vitadapter_torch.ops.cuda_ext")
    assert harness.forbidden_modules(mods) == []
    assert "vitadapter_torch" in mods


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "import port_bench.reference.builder, port_bench.check\n"
        "import port_bench.reference.train.trainer, port_bench.flops")
    assert not [m for m in mods if m.split(".")[0] == "vitadapter_torch"]
    assert harness.forbidden_modules(mods) == []


def test_forbidden_names_are_compared_whole():
    names = ["vitadapter_torch.ops", "vitadapter", "vitadapter.models",
             "jaxlib.xla", "jaxtyping", "flax", "flaxen", "jax"]
    assert harness.forbidden_modules(names) == [
        "flax", "jax", "jaxlib.xla", "vitadapter", "vitadapter.models"]

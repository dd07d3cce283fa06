"""The plain reference against the port's CPU path at a tiny size of each
cell's path, the control against the reference, and the reference's
independence from the port."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, feed, harness
from benchmark.reference import plain as P
from benchmark.reference.step import reference_steps
from benchmark.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [harness.load_cell(n).name for n in ("turbo-hq.train", "instant-ngp-hash.train")]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _program(cell, seed):
    prg = harness.Program(cell, feed.seeds(seed, 4), "cpu")
    checked, prog = prg.checked_steps(int(cell.traffic["checked_steps"]))
    return prg, checked, prog


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("own_grid", [False, True])
def test_reference_follows_the_port_in_f32(name, own_grid):
    """The port's CPU path in f32 (plain versions of its kernels) and the
    reference agree to f32 rounding on every number: the march's samples
    and drop rule, the encoder and heads, the MLPs, the composite and loss,
    the gradients, Adam + EMA, and the refresh's grid."""
    cell = tiny_cell(name, bf16=False)
    prg, checked, prog = _program(cell, 2**31 + 3)
    ref = reference_steps(cell.config, prg.weights, prg.scene, checked, prg.trainer_seed,
                          device="cpu", march_grid=None if own_grid else prog)
    g = harness.gaps(prog, ref)
    assert g["loss_gap"] < 1e-5 and g["grid_gap"] == 0.0
    assert g["grad_diff_gap"] < 1e-4 and g["change_gap"] < 1e-5
    assert ref["samples"][0] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    """The reference in scaled float8 (the next precision below the
    configuration's bf16) in the program's place fails one of the cell's
    limits, at this tiny size too."""
    cell = tiny_cell(name, bf16=True)
    limits = cell.data["limits"]
    for seed in (1, 2, 3):
        r = calibrate.readings(cell, seed, "cpu", kinds=("control",))
        assert any(r["control"][k] > lim for k, lim in limits.items()), (seed, r["control"])


def test_fp8_rounding():
    x = torch.tensor([1.0, 1.0625, 3.0, -448.0, 1e-3])
    y = P.Rounding("fp8")(x)
    # the scale is max |x| / 448 = 1: e4m3 keeps 3 mantissa bits
    assert y.tolist()[:4] == [1.0, 1.0, 3.0, -448.0]
    assert P.Rounding("f32")(x) is x
    # the gradient: scaled e5m2, 2 mantissa bits (max |g| / 57344 = 2^-15)
    x.requires_grad_()
    g = torch.tensor([1.75, 1.125, 0.875, -0.8, 1e-3])
    P.Rounding("fp8")(x).backward(g)
    assert x.grad.tolist()[:4] == [1.75, 1.0, 0.875, -0.75]


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.step, benchmark.reference.plain, "
            "benchmark.yardstick, benchmark.feed, benchmark.trace; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('ngp_tpu')))"
            ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"

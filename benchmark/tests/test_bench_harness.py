"""The harness on the CPU: every file BENCHMARK.json names is found by
name, the result line's schema, the no-JAX guard, the launch-set check,
and a run with the timed path broken underneath coming out not correct.

Run: python -m pytest benchmark/tests -q (from the repository's root).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg), c["name"]
    for w in BENCH["workloads"]:
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
        cell = harness.load_cell(w["name"])
        assert cell.config["network"] and cell.traffic["rays_per_step"] > 0
        assert set(cell.data["limits"]) <= {"loss_gap", "grad_diff_gap", "change_gap",
                                            "grid_gap"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert callable(reader.read), m["name"]


def test_a_metric_split_by_cell_reads_its_base_metric_file():
    split = harness.load_reader("train_rays_per_s.turbo")
    assert Path(split.__file__).name == "train_rays_per_s.py"
    assert Path(harness.load_reader("roofline.hash_fwd").__file__).name == "roofline.hash_fwd.py"


def test_benchmark_json_keeps_the_contract():
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = {m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", CELLS)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", CELLS)]
        assert layer and all(m["moves"] in mine for m in layer)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["ngp_tpu_torch", "ngp_tpu_torch.ops.kernels", "ngp_tpu", "ngp_tpu.ops",
            "jax", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy", "jaxlib",
                                               "ngp_tpu", "ngp_tpu.ops"]
    assert harness.forbidden_modules(["ngp_tpu_torch.models.nerf"]) == []


def test_nothing_the_benchmark_runs_imports_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness, calibrate; "
            "from benchmark.tests.tiny import tiny_cell; import torch; "
            "torch.set_num_threads(1); "
            "harness.run_cell(tiny_cell('turbo-hq.train'), 1, 0.2, False, device='cpu'); "
            "print(harness.forbidden_modules(list(sys.modules)))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the run on a machine without an NVIDIA GPU")


def test_run_without_a_card_fails_and_prints_no_result(no_card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_launch_set_check():
    spec = {"must": ["march_turbo", "cp_density_fwd*"], "must_not": ["grid_encode_*"]}
    ok = {"march_turbo": 3, "cp_density_fwd": 0, "cp_density_fwd_tc": 2, "grid_encode_fwd": 0}
    assert harness.launch_problems(ok, spec) == []
    bad = dict(ok, march_turbo=0, grid_encode_bwd=1)
    problems = harness.launch_problems(bad, spec)
    assert len(problems) == 2 and "march_turbo" in problems[0] and "grid_encode" in problems[1]


def _tiny_f32(name):
    """A tiny cell in f32 (so the program matches the reference to f32
    rounding) whose launch set is not checked (the CPU runs no kernel)."""
    cell = tiny_cell(name, bf16=False)
    cell.data["launches"] = {}
    return cell


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(name, trace):
    cell = _tiny_f32(name)
    res = harness.run_cell(cell, 2**31 + 11, 0.3, trace, device="cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for k, v in res["metrics"].items():
        assert wanted[k] == v["unit"] and isinstance(v["value"], float)
    if not trace:
        host = {m["name"] for m in cell.end_to_end} & {"train_rays_per_s", "step_ms_p95"}
        assert host | {"setup_s"} <= set(res["metrics"])
    assert set(res["checks"]) == set(cell.data["limits"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def _unchanged(monkeypatch, name):
    from ngp_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(Trainer, "_apply_gradients", lambda self: None)


def _half_batch(monkeypatch, name):
    from ngp_tpu_torch.training import nerf

    orig = nerf.sample_ray_indices

    def half(*a, **k):
        out = orig(*a, **k)
        inds = out["inds"]
        n = inds.shape[0] // 2
        return dict(out, inds=torch.cat([inds[:n], inds[:n]]))

    monkeypatch.setattr(nerf, "sample_ray_indices", half)


def _alter(monkeypatch, name):
    from ngp_tpu_torch.ops import cpgrid, hashgrid

    def zero_rows(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            keep = torch.arange(out.shape[0], device=out.device) % 16 != 0
            return out * keep[:, None].to(out.dtype)
        return wrapped

    monkeypatch.setattr(cpgrid, "cp_density_plain", zero_rows(cpgrid.cp_density_plain))
    monkeypatch.setattr(hashgrid, "grid_encode_plain", zero_rows(hashgrid.grid_encode_plain))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _alter])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """The run drives the whole cell but the look for a card, with the
    timed path broken: a step that leaves its state unchanged, half of the
    batch left out (the mean over the rest), the density head's output or
    the encoder's features of every 16th sample altered where produced.
    One chip: no exchange between chips to leave out."""
    fault(monkeypatch, name)
    res = harness.run_cell(_tiny_f32(name), 2**31 + 21, 0.2, False, device="cpu")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**32 + 7), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"

"""The port's spans and counters (``ngp_tpu_torch/tracing.py``) on the CPU:
off the profiler a step enters no ``record_function`` and counts nothing;
under ``torch.profiler`` every step is one ``ngp/step`` holding its phases
in order, with the march inside the forward; the kernels' wrappers are
spans; the sample counters add up to the renders' own counts, the MLPs' row
counter to their calls' rows; the benchmark's
readers of those spans (``benchmark/program_trace.py``) on a hand-made
trace; ``Trainer.profile_steps``' trace file.
"""

import itertools
import json
import os

import pytest
import torch

from benchmark import program_trace
from benchmark.trace import Profile
from ngp_tpu_torch import tracing
from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
from ngp_tpu_torch.data.synthetic import make_synthetic_frames
from ngp_tpu_torch.models import occupancy
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.models.nerf import NeRFNetwork
from ngp_tpu_torch.ops.kernels import cp, hashgrid
from ngp_tpu_torch.training import nerf_grid
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

PHASES = ["batch", "forward", "backward", "update"]
# a CPU tensor takes the plain versions without the kernels' wrappers, so
# a CPU step's phases hold no span but the march's
INSIDE = {"forward": {"march"}}
# the kernels' wrappers as spans: (module, wrapper, its positional
# arguments, the plain version it calls on the CPU, span)
WRAPPERS = [(cp, "cp_density_fwd", 6, "cp_density_plain", "density_head"),
            (cp, "cp_bwd_banks", 4, "cp_bwd_banks_plain", "factor_grad"),
            (hashgrid, "grid_encode_fwd", 3, "grid_encode_plain", "hash_fwd"),
            (hashgrid, "grid_encode_bwd", 3, "grid_encode_bwd_plain", "hash_table_grad")]


@pytest.fixture(autouse=True)
def _clean_counters():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.reset_counters()
    yield
    tracing.reset_counters()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=16, W=16, num_steps=64,
                                 device="cpu")["train"]


def _trainer(march, workspace):
    if march == "turbo":
        ncfg = NetworkConfig(encoding="cpgrid", cp_resolutions=(16, 32), cp_rank=4,
                             cp_freq_degree=2, use_bf16=False)
    else:
        ncfg = NetworkConfig(encoding="hashgrid", num_levels=4, log2_hashmap_size=10,
                             use_bf16=False)
    rcfg = RenderConfig(grid_size=16, max_steps=64, max_samples_per_ray=16, min_near=0.05,
                        density_thresh=10.0, turbo=march == "turbo", coarse_candidates=32,
                        crossing_slots=8, compact_mean_samples=4)
    torch.manual_seed(0)
    model = NeRFNetwork(ncfg, rcfg, device="cpu")
    return GridNeRFTrainer(model, rcfg, TrainConfig(num_rays=128, workspace=str(workspace)),
                           log_every=10**9, use_tensorboard=False, workspace=str(workspace))


def _batches(trainer, frames, n):
    epoch = trainer.make_loader(frames)
    return list(itertools.islice(itertools.chain(epoch(), epoch()), n))


def _ngp_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X" and e["name"].startswith(tracing.PREFIX)),
                  key=lambda e: e["ts"])


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("march", ["turbo", "v1"])
def test_no_profiler_no_ranges_and_no_counts(march, frames, tmp_path, monkeypatch):
    """Off the profiler two steps (the first refreshes the grid) enter no
    ``record_function`` and count nothing; with the profiler's flag set,
    the same calls reach the patched ``record_function``."""
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    trainer = _trainer(march, tmp_path)
    batches = _batches(trainer, frames, 3)
    for b in batches[:2]:
        trainer.step(b)
    assert entered == [] and tracing.COUNTERS == {}
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    trainer.step(batches[2])
    assert entered[:2] == ["ngp/step", "ngp/batch"]
    assert set(PHASES) | {"step", "march"} <= {n[len(tracing.PREFIX):] for n in entered}
    assert set(tracing.COUNTERS) >= {"samples_evaluated", "samples_composited"}


@pytest.mark.parametrize("march", ["turbo", "v1"])
def test_profiled_steps_nest_their_phases_in_order(march, frames, tmp_path):
    trainer = _trainer(march, tmp_path)
    batches = _batches(trainer, frames, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for b in batches:
            trainer.step(b)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = _ngp_spans(tmp_path / "trace.json")
    steps = [s for s in spans if s["name"] == "ngp/step"]
    assert len(steps) == 3
    for i, step in enumerate(steps):
        inside = [s for s in spans if s is not step and _inside(s, step)]
        phases = [s for s in inside if s["name"][4:] in set(PHASES) | {"refresh"}]
        assert [s["name"][4:] for s in phases] == (["refresh"] if i == 0 else []) + PHASES
        for a, b in zip(phases[:-1], phases[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        for ph in phases:
            held = {s["name"][4:] for s in inside if s is not ph and _inside(s, ph)}
            assert held == INSIDE.get(ph["name"][4:], set()), ph["name"]


@pytest.mark.parametrize("module,wrapper,n_args,plain,name", WRAPPERS)
def test_kernel_wrappers_are_spans(module, wrapper, n_args, plain, name, monkeypatch, tmp_path):
    monkeypatch.setattr(module, plain, lambda *a, **k: "plain")
    fn = getattr(module, wrapper)
    args = (torch.zeros(1, 3),) + (None,) * (n_args - 1)
    assert fn(*args) == "plain"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert fn(*args) == "plain"
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert [s["name"] for s in _ngp_spans(tmp_path / "trace.json")] == ["ngp/" + name]


@pytest.mark.parametrize("march", ["turbo", "v1"])
def test_counters_add_up_to_the_renders_own_counts(march, frames, tmp_path, monkeypatch):
    seen = {"evaluated": 0, "composited": 0, "dropped": 0}
    name = "render_rays_grid_turbo" if march == "turbo" else "render_rays_grid"
    render = getattr(nerf_grid, name)

    def counted(*a, **k):
        out = render(*a, **k)
        seen["composited"] += int(out["n_samples"])
        # the turbo march's drops past its crossing slots are estimates
        seen["dropped"] += float(out.get("n_dropped", 0))
        if march == "v1":
            seen["evaluated"] += out["ts"].numel()
        return out

    geometry = occupancy._turbo_compact_geometry

    def budget(*a, **k):
        out = geometry(*a, **k)
        seen["evaluated"] += out[2]
        return out

    mlp_forward = MLP.forward

    def mlp_rows(self, x):
        seen["mlp_rows"] = seen.get("mlp_rows", 0) + x.numel() // x.shape[-1]
        return mlp_forward(self, x)

    monkeypatch.setattr(nerf_grid, name, counted)
    monkeypatch.setattr(occupancy, "_turbo_compact_geometry", budget)
    monkeypatch.setattr(MLP, "forward", mlp_rows)
    trainer = _trainer(march, tmp_path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for b in _batches(trainer, frames, 2):
            trainer.step(b)
    totals = tracing.counter_totals()
    assert 0 < seen["composited"] < seen["evaluated"]
    # the MLPs' rows (on the CPU none takes the fused route)
    want = {"samples_evaluated": seen["evaluated"], "samples_composited": seen["composited"],
            "mlp_rows": seen["mlp_rows"]}
    if march == "turbo":
        assert seen["evaluated"] == 2 * 128 * 4 and seen["dropped"] > 0
        want["samples_dropped"] = seen["dropped"]
    else:
        assert seen["evaluated"] == 2 * 128 * 16
    assert totals == pytest.approx(want, rel=1e-12)


def _x(name, ts, dur, tid=1, cat="user_annotation", corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _hand_made_events():
    """Two steps on thread 1. Device work in us: [0, 10], [30, 40],
    [45, 60], [100, 110], [150, 160], [300, 305], each launched by a
    runtime call of the same correlation: in the refresh, the batch, the
    march (outside any operator, as a ctypes launch is), the update,
    ``ngp/factor_grad`` on thread 2 (the autograd engine's), and after
    the second step."""
    host = [
        _x("ngp/step", 0, 100), _x("ngp/refresh", 0, 25), _x("ngp/batch", 25, 15),
        _x("ngp/forward", 40, 30), _x("ngp/march", 42, 10),
        _x("aten::mul", 44, 2, cat="cpu_op"), _x("ngp/backward", 70, 20),
        _x("ngp/update", 90, 10),
        _x("ngp/step", 120, 160), _x("ngp/batch", 120, 10), _x("ngp/forward", 130, 20),
        _x("ngp/backward", 150, 100), _x("ngp/update", 250, 20),
        _x("ngp/factor_grad", 148, 30, tid=2), _x("aten::add", 290, 5, cat="cpu_op"),
    ]
    launches = [(0.5, 1), (29, 1), (43, 1), (95, 1), (149, 2), (291, 1)]
    device = [(0, 10), (30, 10), (45, 15), (100, 10), (150, 10), (300, 5)]
    for i, ((t, tid), (ts, dur)) in enumerate(zip(launches, device)):
        host.append(_x("cudaLaunchKernel", t, 1, tid=tid, cat="cuda_runtime", corr=i))
        host.append(dict(_x(f"k{i}", ts, dur, cat="kernel", corr=i), pid=0, tid=7))
    return host


def test_idle_by_phase_on_a_hand_made_trace():
    """Gaps (middle): [10, 30] (20, refresh), [40, 45] (42.5, forward),
    [60, 100] (80, backward), [110, 150] (130: the second step's
    forward begins there), [160, 300] (230, backward)."""
    by_phase, other = program_trace.idle_by_phase(Profile(_hand_made_events(), 2, 1.0))
    assert by_phase == pytest.approx({"refresh": 20e-6, "batch": 0.0, "forward": 45e-6,
                                      "backward": 180e-6, "update": 0.0})
    assert other == {}
    # a gap outside every step is named by the innermost host range there
    events = _hand_made_events() + [dict(_x("k6", 400, 5, cat="kernel"), pid=0),
                                    _x("aten::copy_", 345, 20, cat="cpu_op")]
    by_phase, other = program_trace.idle_by_phase(Profile(events, 2, 1.0))
    assert other == pytest.approx({"aten::copy_": 95e-6})
    assert program_trace.idle_by_phase(Profile([], 1, 1.0)) is None


def test_span_device_s_follows_the_launch_calls():
    events = _hand_made_events()
    assert program_trace.span_device_s(events, "march") == pytest.approx(15e-6)
    assert program_trace.span_device_s(events, "refresh") == pytest.approx(10e-6)
    assert program_trace.span_device_s(events, "update") == pytest.approx(10e-6)
    # launched on the engine's thread, inside the range there
    assert program_trace.span_device_s(events, "factor_grad") == pytest.approx(10e-6)
    assert program_trace.span_device_s(events, "march", within="forward") == pytest.approx(15e-6)
    assert program_trace.span_device_s(events, "march", within="backward") is None
    assert program_trace.span_device_s(events, "hash_fwd") is None


def test_profile_steps_writes_trace(frames, tmp_path):
    trainer = _trainer("turbo", tmp_path)
    logdir = trainer.profile_steps(trainer.make_loader(frames), n_steps=3)
    assert logdir == os.path.join(str(tmp_path), "profile")
    (name,) = os.listdir(logdir)
    steps = [s for s in _ngp_spans(os.path.join(logdir, name)) if s["name"] == "ngp/step"]
    assert len(steps) == 3 and trainer.global_step == 3
    assert tracing.COUNTERS == {}

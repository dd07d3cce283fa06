"""One run of one cell: set-up, the measured window, the traced stage, the
comparison with the reference, and the result line.

Everything a cell is sits in files that the harness finds by the names in
``BENCHMARK.json``: the configuration (``configs/<config>.json``), the
traffic mix (``traffic/<traffic>.json``), the cell's own data
(``workloads/<cell>.json``: its launch set and the limits of the numbers
compared) and one reader per metric (``metrics/<metric>.py``, a
``read(run)`` that returns a number or None, optional ``SPANS``, and
``PROFILE = True`` where it reads the profiled stage in a ``--trace 0``
run too). A metric split by cell (``<metric>.<part>``) with no file of
its own is read by its base metric's file.
"""

from __future__ import annotations

import fnmatch
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import feed as feed_lib
from benchmark.spans import Instruments
from benchmark.trace import Profile, profile_steps

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ngp_tpu")
BETA1 = 0.9  # Adam's first-moment decay in the port (training/state.py)


def forbidden_modules(names) -> List[str]:
    """The module names whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``ngp_tpu_torch`` is not ``ngp_tpu``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_imports(where: str) -> None:
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"benchmark: {where}: forbidden modules imported: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        sys.exit(3)


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    data: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read_json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"benchmark: no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read_json(root / conf["file"]),
        traffic=_read_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        data=_read_json(root / "benchmark" / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def load_reader(name: str, root: Path = ROOT) -> types.ModuleType:
    base = name
    while not (root / "benchmark" / "metrics" / f"{base}.py").is_file() and "." in base:
        base = base.rsplit(".", 1)[0]
    path = root / "benchmark" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def make_weights(model: torch.nn.Module, rules: List[Dict], seed: int, device) -> Dict:
    """Every parameter drawn on ``device`` from one generator seeded with
    ``seed``, by the first rule whose ``match`` (a glob) fits its name,
    copied into the model; returns the drawn tensors by name."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            rule = next((r for r in rules if fnmatch.fnmatch(name, r["match"])), None)
            if rule is None:
                raise ValueError(f"no init rule for parameter {name}")
            t = torch.empty(p.shape, dtype=torch.float32, device=device)
            if rule["dist"] == "normal":
                t.normal_(0.0, float(rule["std"]), generator=gen)
            elif rule["dist"] == "uniform":
                t.uniform_(float(rule["low"]), float(rule["high"]), generator=gen)
            elif rule["dist"] == "lecun_normal":
                # flax's Dense default: normal truncated at 2 sigma, variance
                # 1 / fan_in ([in, out] kernels); 0.8796 is that normal's std
                torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t *= math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
            else:
                raise ValueError(f"unknown init {rule['dist']!r}")
            p.copy_(t)
            out[name] = t.cpu()
    return out


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The program's readings against the reference's.

    loss_gap: the largest |loss - ref| / |ref| over the checked steps.
    grad_diff_gap: over the same parameters as change_gap, the largest norm
    of the first gradients' difference over the reference gradient's norm,
    |g - g_ref| / |g_ref|.
    change_gap: the same of the norms of the parameters' and EMA shadows'
    change after the checked steps, over the parameters whose reference
    gradient is at least 1e-3 of the median's.
    grid_gap: the share of grid cells whose occupancy after the first
    refresh differs."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))}
    g_ref = ref["grad"]
    med = statistics.median(g_ref.values())
    keep = [k for k, g in g_ref.items() if g >= 1e-3 * med]
    out["grad_diff_gap"] = max(grad_diffs(prog, ref, keep).values())
    keys = keep + ["ema/" + k for k in keep]
    c_ref = {k: ref["change"][k] for k in keys}
    med_c = statistics.median(c_ref.values())
    out["change_gap"] = max(abs(prog["change"][k] - c) / max(c, med_c) for k, c in c_ref.items())
    out["grid_gap"] = float((prog["occ"].cpu() != ref["occ"].cpu()).float().mean())
    return out


def grad_diffs(prog: Dict, ref: Dict, keys) -> Dict[str, float]:
    """|g - g_ref| / |g_ref| of the first gradients, per parameter."""
    out = {}
    for k in keys:
        g_ref = ref["grad_vec"][k].detach().float().cpu()
        diff = torch.linalg.vector_norm(prog["grad_vec"][k].float().cpu() - g_ref)
        out[k] = float(diff) / float(torch.linalg.vector_norm(g_ref))
    return out


def launch_problems(launches: Dict[str, int], spec: Dict) -> List[str]:
    """The cell's launch set: each ``must`` pattern matches a kernel that
    launched, no ``must_not`` pattern matches one."""
    bad = []
    for pat in spec.get("must", []):
        if not any(n for k, n in launches.items() if fnmatch.fnmatch(k, pat)):
            bad.append(f"{pat} never launched")
    for pat in spec.get("must_not", []):
        hit = {k: n for k, n in launches.items() if fnmatch.fnmatch(k, pat) and n}
        if hit:
            bad.append(f"{pat} launched: {hit}")
    return bad


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class Run:
    """What the metric readers read."""

    def __init__(self, cell: Cell):
        self.config, self.traffic = cell.config, cell.traffic
        self.window: Dict = {}
        self.setup_s: Optional[float] = None
        self.peak_window_bytes: Optional[int] = None
        self.profile: Optional[Profile] = None
        self.captures: Dict[str, list] = {}
        self.counts: Dict[str, object] = {}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Clock:
    """Per-step end marks: CUDA events on the card, host times elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks[:-1], self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks[:-1], self.marks[1:])]


def _program(cell: Cell, device):
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig

    cfg = cell.config
    ncfg = NetworkConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in cfg["network"].items()})
    rcfg = RenderConfig(**cfg["render"])
    tcfg = TrainConfig(**cfg["train"], num_rays=int(cell.traffic["rays_per_step"]))
    return ncfg, rcfg, tcfg


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             process_start: Optional[float] = None) -> Dict:
    """One run; returns the result line's dict."""
    t_start = process_start if process_start is not None else time.time()
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    readers = {n: load_reader(n) for n in names}
    inst = Instruments([s for r in readers.values() for s in getattr(r, "SPANS", [])])
    if trace:
        inst.install()
    try:
        return _run(cell, seconds, trace, device, t_start, readers, inst,
                    feed_lib.seeds(seed, 4))
    finally:
        inst.uninstall()


class Program:
    """The program under test, set up from the run's seed: the scene, the
    model with the benchmark's weights, the trainer and the feed; then its
    checked steps, through the window's own call and feed."""

    def __init__(self, cell: Cell, sub_seeds, device):
        from ngp_tpu_torch.models.nerf import NeRFNetwork
        from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

        s_weights, s_order, s_draws, self.trainer_seed = sub_seeds
        traffic, cfg = cell.traffic, cell.config
        ncfg, rcfg, self.tcfg = _program(cell, device)
        self.scene = feed_lib.make_scene(traffic, device)
        self.model = NeRFNetwork(ncfg, rcfg, device=device)
        self.weights = make_weights(self.model, cfg["init"], s_weights, device)
        workspace = os.path.join(tempfile.gettempdir(), "ngp_bench_workspace")
        self.trainer = GridNeRFTrainer(self.model, rcfg, self.tcfg, seed=self.trainer_seed,
                                       log_every=10**9, use_tensorboard=False,
                                       workspace=workspace)
        _, H, W, _ = self.scene.images.shape
        self.trainer.mark_untrained(self.scene.poses.cpu().numpy(),
                                    self.scene.intrinsics.cpu().numpy(), H, W)
        self.feed = feed_lib.Feed(traffic, self.scene, s_order, s_draws)

    def checked_steps(self, n: int):
        """Run ``n`` steps; returns (their (frame, draws) for the reference,
        the program's readings: losses, the first step's gradient from
        Adam's first moment, the parameters' and EMA shadows' change, the
        first refresh's occupancy grid)."""
        trainer, weights = self.trainer, self.weights
        names = sorted(weights)
        params = dict(self.model.named_parameters())
        checked, losses, grad_vec = [], [], None
        for i in range(n):
            batch, draws = self.feed.next()
            checked.append((batch["idx"], {k: v.cpu() for k, v in draws.items()}))
            losses.append(trainer.step(batch, draws)["loss"])
            if i == 0:
                state = trainer.optimizer.state
                # a parameter the optimizer never stepped has no moment: no gradient
                grad_vec = {k: (state[params[k]]["exp_avg"] / (1 - BETA1)).cpu()
                            if "exp_avg" in state.get(params[k], {})
                            else torch.zeros(params[k].shape) for k in names}
        with torch.no_grad():
            change = {k: torch.linalg.vector_norm(params[k].cpu() - weights[k]) for k in names}
            change.update({"ema/" + k: torch.linalg.vector_norm(trainer.ema.shadow[k].cpu()
                                                                - weights[k]) for k in names})
        prog = {"losses": [float(v) for v in losses], "grad_vec": grad_vec,
                "change": {k: float(v) for k, v in change.items()},
                "occ": trainer.aux["occ"].occ_grid.cpu(),
                "density": trainer.aux["occ"].density_grid.cpu()}
        return checked, prog


def _run(cell, seconds, trace, device, t_start, readers, inst, sub_seeds):
    from ngp_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from benchmark.reference.step import reference_steps

    run = Run(cell)
    traffic, cfg = cell.traffic, cell.config
    n_check, warmup = int(traffic["checked_steps"]), int(traffic["warmup_steps"])
    if n_check >= int(cfg["train"]["update_extra_interval"]):
        raise ValueError("the checked steps must end before the second grid refresh")
    reset_launch_counts()
    marks = [("start", t_start), ("imports", time.time())]
    prg = Program(cell, sub_seeds, device)
    trainer, feed, tcfg = prg.trainer, prg.feed, prg.tcfg
    marks.append(("scene and model", time.time()))
    checked, prog = prg.checked_steps(n_check)
    marks.append(("checked steps", time.time()))
    for _ in range(n_check, warmup):
        trainer.step(*feed.next())
    _sync(device)
    marks.append(("warm-up steps", time.time()))
    print("set-up s: " + ", ".join(f"{name} {t - t0:.2f}" for (_, t0), (name, t)
                                    in zip(marks[:-1], marks[1:])), file=sys.stderr, flush=True)
    peak_setup = torch.cuda.max_memory_allocated() if _is_cuda(device) else 0

    # the measured window; set-up's objects are kept out of the collector's
    # full passes, which a host-paced step would otherwise wait on
    gc.collect()
    gc.freeze()
    if _is_cuda(device):
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.time() - t_start
    clock = _Clock(device)
    inst.counting = trace
    host_s, window_losses = [], []
    clock.mark()
    t0 = time.perf_counter()
    while True:
        batch, draws = feed.next()
        h0 = time.perf_counter()
        window_losses.append(trainer.step(batch, draws)["loss"])
        h1 = time.perf_counter()
        clock.mark()
        host_s.append(h1 - h0)
        if h1 - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    inst.counting = False
    steps = len(host_s)
    run.window = {"steps": steps, "seconds": window_s, "rays": steps * tcfg.num_rays,
                  "step_ms": clock.intervals_ms(), "host_s": host_s}
    run.counts = {k: float(v) for k, v in inst.counts.items()}
    print(f"window: {steps} steps in {window_s:.3f} s", file=sys.stderr, flush=True)
    if _is_cuda(device):
        run.peak_window_bytes = torch.cuda.max_memory_allocated()

    # the profiled stage: the per-layer metrics' spans and captures with
    # --trace 1, the device time alone where an end-to-end reader asks
    if trace or any(getattr(r, "PROFILE", False) for r in readers.values()):
        inst.profiling = trace
        inst.capture_left = {s["span"]: 2 for s in inst.specs} if trace else {}
        n_prof = int(traffic["profiled_steps"])
        if _is_cuda(device):
            run.profile = profile_steps(lambda: trainer.step(*feed.next()), n_prof,
                                        tempfile.gettempdir())
        else:
            for _ in range(n_prof):
                trainer.step(*feed.next())
        inst.profiling = False
        run.captures = inst.captures
        if run.profile is not None:
            spans = {k: (len(v), sum(n for _, n in v)) for k, v in run.profile.spans.items()}
            print(f"traced: {len(run.profile.device)} device events in {n_prof} steps; "
                  f"spans (instances, device events): {spans}", file=sys.stderr, flush=True)
    peak_all = max(peak_setup, torch.cuda.max_memory_allocated()) if _is_cuda(device) else 0
    launches = dict(LAUNCHES)
    bad_losses = int((~torch.isfinite(torch.stack(window_losses))).sum())

    # the readers, then the program's state freed before the reference runs
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    breakdown = run.profile.breakdown() if run.profile is not None else None
    busy_wall = (run.profile.busy_s, run.profile.wall_s) if run.profile is not None else None
    run.captures = inst.captures = {}
    weights, scene, trainer_seed = prg.weights, prg.scene, prg.trainer_seed
    del prg, trainer, batch, draws, window_losses, feed
    gc.unfreeze()
    gc.collect()
    if _is_cuda(device):
        torch.cuda.empty_cache()

    ref = reference_steps(cfg, weights, scene, checked, trainer_seed, device=device,
                          march_grid=prog)
    numbers = gaps(prog, ref)
    limits = cell.data["limits"]
    print("not compared: " + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()
                                       if k not in limits), file=sys.stderr, flush=True)
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    problems = [f"{k} {c['value']:.6g} over its limit {c['limit']}" for k, c in checks.items()
                if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]
    problems += launch_problems(launches, cell.data["launches"])
    if bad_losses:
        problems.append(f"{bad_losses} window steps with a non-finite loss")
    for p in problems:
        print(f"benchmark: not correct: {p}", file=sys.stderr, flush=True)
    result = {"correct": not problems, "attempted": steps, "failed": bad_losses,
              "metrics": metrics, "device": device_line(device, cell.chips, peak_all)}
    if busy_wall is not None:
        result["device"]["busy_s"], result["device"]["window_s"] = busy_wall
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_line(device, count: int, peak: int) -> Dict:
    if not _is_cuda(device):
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w()}

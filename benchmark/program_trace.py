"""What the program's own spans and counters (``ngp_tpu_torch/tracing.py``)
say about the profiled stage.

The program opens ``ngp/<name>`` ranges while a profiler records:
``ngp/step`` around ``Trainer.step``, inside it the phases ``refresh``,
``batch``, ``forward``, ``backward`` and ``update`` one after another on
the calling thread, and ranges around the march and the kernels' wrappers.
It counts a render's samples (``samples_evaluated``,
``samples_composited``, ``samples_dropped``) only while a profiler
records, so in a ``--trace 1`` run the counters cover the profiled steps
alone. A program without them (a tree older than its tracing) gives no
span and no counter, and every function here returns None or nothing.

Run it to see a cell's traced stage through both sets of spans:

    python3 -m benchmark.program_trace --workload <cell> --seed <n>

(from the root of a checkout, on a card) runs the cell as ``--trace 1``
does, then prints one JSON line: each program span's device ms a step
beside the benchmark's ``bench/`` span over the same calls, the idle gaps
by phase and the rest by label, the counters a step and the host's ms a
profiled step.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from benchmark.trace import LAUNCH_CATS, Profile, _merged

PREFIX = "ngp/"
PHASES = ("refresh", "batch", "forward", "backward", "update")


def _spans(profile: Profile, name: str) -> Dict[tuple, List[dict]]:
    """The ``ngp/<name>`` ranges by (pid, tid), in order of start."""
    out: Dict[tuple, List[dict]] = {}
    for e in profile.host:
        if e["name"] == PREFIX + name and e.get("cat") == "user_annotation":
            out.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for v in out.values():
        v.sort(key=lambda e: e["ts"])
    return out


def _holder(spans: List[dict], starts: List[float], ts: float, end: float) -> Optional[dict]:
    """The last of ``spans`` (sorted, not nested in each other) that
    starts at or before ``ts``, if it lasts to ``end``."""
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and spans[i]["ts"] + spans[i].get("dur", 0) >= end:
        return spans[i]
    return None


def idle_by_phase(profile: Profile) -> Optional[Tuple[Dict[str, float], Dict[str, float]]]:
    """(seconds of the idle gaps between device work by the phase of the
    step that holds each gap's middle, seconds of the other gaps by the
    innermost host range at their middle); None without ``ngp/step``.

    A gap is one between the merged intervals of the device's events. Its
    phase is the ``ngp/<phase>`` range on the thread of an ``ngp/step``
    range, inside that step, that holds the gap's middle."""
    steps = _spans(profile, "step")
    if not steps:
        return None
    # per step: its phases, by start
    runs = []
    for key, ss in steps.items():
        phases = sorted((p for ph in PHASES for p in _spans(profile, ph).get(key, [])),
                        key=lambda e: e["ts"])
        pstarts = [p["ts"] for p in phases]
        for s in ss:
            a = bisect.bisect_left(pstarts, s["ts"])
            b = bisect.bisect_right(pstarts, s["ts"] + s.get("dur", 0))
            runs.append((s, phases[a:b]))
    runs.sort(key=lambda r: r[0]["ts"])
    run_starts = [r[0]["ts"] for r in runs]
    host = sorted(profile.host, key=lambda e: e["ts"])
    by_phase = {ph: 0.0 for ph in PHASES}
    other: Dict[str, float] = {}
    active, j = [], 0
    ends = _merged(profile.device)
    for (_, a1), (b0, _) in zip(ends[:-1], ends[1:]):
        mid, secs = 0.5 * (a1 + b0), (b0 - a1) / 1e6
        i = bisect.bisect_right(run_starts, mid) - 1
        phase = None
        if i >= 0 and runs[i][0]["ts"] + runs[i][0].get("dur", 0) >= mid:
            phases = runs[i][1]
            k = bisect.bisect_right([p["ts"] for p in phases], mid) - 1
            if k >= 0 and phases[k]["ts"] + phases[k].get("dur", 0) >= mid:
                phase = phases[k]["name"][len(PREFIX):]
        while j < len(host) and host[j]["ts"] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h["ts"] + h.get("dur", 0) >= mid]
        if phase is not None:
            by_phase[phase] += secs
            continue
        inner = min(active, key=lambda h: h.get("dur", 0), default=None)
        label = inner["name"] if inner is not None else "(no host op)"
        other[label] = other.get(label, 0.0) + secs
    return by_phase, other


def span_device_s(events: List[dict], name: str, within: Optional[str] = None) -> Optional[float]:
    """Device seconds launched inside ``ngp/<name>`` (with ``within``, only
    the ranges that lie inside an ``ngp/<within>`` range on their thread),
    from a Chrome trace's events; None where the program opened no such
    range.

    A device event (kernel, copy, fill) shares its ``correlation`` with the
    runtime call that launched it (``cudaLaunchKernel`` and the like, on
    the launching thread); the event is the span's where a ``ngp/<name>``
    range on that call's pid and tid holds the call. (The device event's
    ``External id`` names the innermost operator open at the launch, not
    a range: a kernel launched through ctypes inside a range but outside
    any operator names an operator around the range.)"""
    profile = Profile(events, 1, 1.0)
    spans = _spans(profile, name)
    if within is not None:
        outer = _spans(profile, within)
        for key, ss in spans.items():
            os_ = outer.get(key, [])
            starts = [o["ts"] for o in os_]
            spans[key] = [s for s in ss
                          if _holder(os_, starts, s["ts"], s["ts"] + s.get("dur", 0))]
    if not any(spans.values()):
        return None
    starts = {k: [s["ts"] for s in v] for k, v in spans.items()}
    launch_at = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch_at[corr] = ((e.get("pid"), e.get("tid")), e["ts"])
    secs = 0.0
    for d in profile.device:
        key, ts = launch_at.get((d.get("args") or {}).get("correlation"), (None, None))
        if key in spans and _holder(spans[key], starts[key], ts, ts):
            secs += d["dur"] / 1e6
    return secs


def _totals() -> Dict[str, float]:
    try:
        from ngp_tpu_torch import tracing
    except ImportError:
        return {}
    return tracing.counter_totals()


def counters(run) -> Dict[str, float]:
    """The program's counter totals over the profiled stage; empty where the
    run has no profile or the program no counters."""
    return {} if getattr(run, "profile", None) is None else _totals()


def idle_ms(run, phase: str) -> Optional[float]:
    """Device idle ms a profiled step in the gaps that ``phase`` holds."""
    p = run.profile
    if p is None or not p.device:
        return None
    split = idle_by_phase(p)
    return None if split is None else 1e3 * split[0][phase] / p.n_steps


# the program's spans (in the range named, or anywhere) set beside the
# benchmark's span of the same name: the ``bench/`` wrappers see only the
# calls made through the module attribute they replace (the training
# forward's, for the density head and the hash encoding)
SPAN_PAIRS = (("march", None), ("refresh", None), ("density_head", "forward"),
              ("density_head", None), ("factor_grad", None), ("hash_fwd", "forward"),
              ("hash_fwd", None), ("hash_table_grad", None))


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from benchmark import harness, trace

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("program_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    kept = []

    class Kept(trace.Profile):
        """The traced stage's profile with its events kept."""

        def __init__(self, events, n_steps, wall_s):
            super().__init__(events, n_steps, wall_s)
            self.events = events
            kept.append(self)

    trace.Profile = Kept
    result = harness.run_cell(cell, args.seed, args.seconds, True, device="cuda")
    prof = kept[0]
    n = prof.n_steps
    spans = {}
    for name, within in SPAN_PAIRS:
        ours = span_device_s(prof.events, name, within)
        theirs = prof.span_s(name)
        if ours is not None or theirs is not None:
            key = name if within is None else f"{name} in {within}"
            spans[key] = {"ngp_ms": None if ours is None else 1e3 * ours / n,
                          "bench_ms": None if theirs is None else 1e3 * theirs / n}
    split = idle_by_phase(prof)
    merged = _merged(prof.device)
    gaps = sum(b0 - a1 for (_, a1), (b0, _) in zip(merged[:-1], merged[1:])) / 1e6

    def per_step(d):
        return {k: 1e3 * v / n for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    line = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
            "n_steps": n, "host_ms_per_profiled_step": 1e3 * prof.wall_s / n,
            "device_ms_per_step": 1e3 * prof.busy_s / n, "idle_gap_ms": 1e3 * gaps / n,
            "spans_ms": spans,
            "idle_ms_by_phase": None if split is None else per_step(split[0]),
            "idle_ms_other": None if split is None else per_step(split[1]),
            "counters_per_step": {k: v / n for k, v in _totals().items()},
            "metrics": result["metrics"], "device": result["device"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The traced stage: ``torch.profiler`` over a fixed number of steps, read
back from its Chrome trace (a frozen copy of ``chip_smoke.py:profile``:
the device work is the events of category kernel, gpu_memcpy and
gpu_memset; the device ranges of annotations overlap the kernels inside
them and are not counted).

Device work is attributed to the benchmark's spans (``record_function``
ranges that ``spans.py`` opens around the port's calls) through the
profiler's correlation ids: a span owns the device events whose launch
(a CUDA runtime or driver event on the span's thread) falls inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench/"


class Profile:
    """What one traced stage recorded."""

    def __init__(self, events: List[dict], n_steps: int, wall_s: float):
        self.n_steps = n_steps
        self.wall_s = wall_s
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.busy_s = _union_s(self.device)
        self.host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
                     and e.get("ph") == "X"]
        self.spans = self._attribute(events)

    def _attribute(self, events) -> Dict[str, List[Tuple[float, int]]]:
        """Span name (without the prefix) -> per instance (device seconds,
        device events) of the work launched inside it."""
        by_corr = {}
        for e in self.device:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                by_corr.setdefault(c, []).append(e)
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c in by_corr:
                    launches.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        for v in launches.values():
            v.sort(key=lambda e: e["ts"])
        starts = {k: [e["ts"] for e in v] for k, v in launches.items()}
        out: Dict[str, List[Tuple[float, int]]] = {}
        for s in events:
            name = s.get("name", "")
            if s.get("cat") != "user_annotation" or not name.startswith(SPAN_PREFIX):
                continue
            key = (s.get("pid"), s.get("tid"))
            lau, ts = launches.get(key, []), starts.get(key, [])
            secs, n = 0.0, 0
            for j in range(bisect.bisect_left(ts, s["ts"]),
                           bisect.bisect_right(ts, s["ts"] + s.get("dur", 0))):
                for d in by_corr[lau[j]["args"]["correlation"]]:
                    secs += d["dur"] / 1e6
                    n += 1
            out.setdefault(name[len(SPAN_PREFIX):], []).append((secs, n))
        return out

    def span_s(self, name: str) -> Optional[float]:
        """Device seconds of all instances of span ``name``; None if none ran."""
        inst = self.spans.get(name)
        if not inst:
            return None
        return sum(s for s, _ in inst)

    def device_s(self, match: Callable[[str], bool]) -> float:
        return sum(e["dur"] for e in self.device if match(e["name"])) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps'
        seconds by the host operation running through each gap (the
        innermost one at the gap's middle)."""
        ops: Dict[str, float] = {}
        for e in self.device:
            ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
        gaps: Dict[str, float] = {}
        ends = _merged(self.device)
        host = sorted(self.host, key=lambda e: e["ts"])
        active, i = [], 0
        for (_, a1), (b0, _) in zip(ends[:-1], ends[1:]):
            mid = 0.5 * (a1 + b0)
            while i < len(host) and host[i]["ts"] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h["ts"] + h.get("dur", 0) >= mid]
            inner = min(active, key=lambda h: h.get("dur", 0), default=None)
            label = inner["name"] if inner is not None else "(no host op)"
            gaps[label] = gaps.get(label, 0.0) + (b0 - a1) / 1e6
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:200], v] for k, v in top_ops],
                "idle_gaps": [[k[:200], v] for k, v in top_gaps]}


def _merged(device: List[dict]) -> List[Tuple[float, float]]:
    """The union of the device events' [ts, ts + dur] intervals, in us."""
    out: List[Tuple[float, float]] = []
    for e in device:
        a, b = e["ts"], e["ts"] + e["dur"]
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _union_s(device: List[dict]) -> float:
    return sum(b - a for a, b in _merged(device)) / 1e6


def profile_steps(step: Callable[[], None], n: int, tmpdir: str) -> Profile:
    """``n`` calls of ``step`` under ``torch.profiler`` (CPU and CUDA
    activity), ending in a device sync; the trace is written under
    ``tmpdir`` and removed once read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    return Profile(events, n, wall)

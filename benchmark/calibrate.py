"""Readings that the limits of a cell's compared numbers are set from.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--out file.json]

For each seed: the program's set-up and checked steps against the
reference (the lower readings), the control against the reference (the
reference computed in the next precision below the configuration's,
scaled float8 for bf16, e4m3 forward and e5m2 backward, in the
program's place: an upper reading),
and the reference with each planted fault against the reference (half
of the batch left out with the mean over the rest; the encoder's
features of every 16th sample zeroed). No measured window: the training
numbers need none. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")

from benchmark import feed as feed_lib  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.reference import plain as P  # noqa: E402
from benchmark.reference.step import reference_steps  # noqa: E402

KINDS = ("program", "control", "half_batch", "alter")


def readings(cell: harness.Cell, seed: int, device, kinds=KINDS):
    """{kind: gaps against the reference} of one seed."""
    import torch

    prg = harness.Program(cell, feed_lib.seeds(seed, 4), device)
    checked, prog = prg.checked_steps(int(cell.traffic["checked_steps"]))
    weights, scene, tseed, cfg = prg.weights, prg.scene, prg.trainer_seed, cell.config
    del prg
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    grid = {"occ": prog["occ"], "density": prog["density"]}
    ref = reference_steps(cfg, weights, scene, checked, tseed, device=device, march_grid=grid)
    out = {}
    if "program" in kinds:
        out["program"] = harness.gaps(prog, ref)
    if "control" in kinds:
        ctl = reference_steps(cfg, weights, scene, checked, tseed, rnd=P.Rounding("fp8"),
                              device=device, march_grid=grid)
        out["control"] = harness.gaps(ctl, ref)
    for fault in ("half_batch", "alter"):
        if fault in kinds:
            bad = reference_steps(cfg, weights, scene, checked, tseed, fault=fault,
                                  device=device, march_grid=grid)
            out[fault] = harness.gaps(bad, ref)
    out["samples"] = ref["samples"]
    out["look"] = look(prog, ref)
    return out


def look(prog, ref):
    """Where the program's gaps come from: each step's loss gap, each
    leaf's gradient gap, and the leaf with the largest change gap with
    both norms."""
    def worst(p, r):
        med = sorted(r.values())[len(r) // 2]
        k = max(r, key=lambda k: abs(p[k] - r[k]) / max(r[k], med))
        return [k, p[k], r[k]]

    return {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
            "change_leaf": worst(prog["change"], ref["change"]),
            "grad_diffs": harness.grad_diffs(prog, ref, ref["grad"])}


def summary(per_seed):
    """Per number: the largest program reading (lower) and the smallest
    reading of the control and of each fault (upper)."""
    names = next(iter(per_seed.values()))["program"].keys()
    out = {}
    for n in names:
        row = {"program_max": max(r["program"][n] for r in per_seed.values())}
        for kind in KINDS[1:]:
            vals = [r[kind][n] for r in per_seed.values() if kind in r]
            if vals:
                row[f"{kind}_min"] = min(vals)
        out[n] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.check_imports("at the start")
    cell = harness.load_cell(args.workload)
    per_seed = {}
    for s in args.seeds:
        per_seed[s] = readings(cell, s, "cuda")
        print(json.dumps({"seed": s, **per_seed[s]}), flush=True)
    result = {"workload": args.workload, "seeds": per_seed, "summary": summary(per_seed)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result["summary"]), flush=True)
    harness.check_imports("at the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())

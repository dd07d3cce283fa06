"""Run one benchmark cell once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix
and metrics come from ``BENCHMARK.json`` and the files under
``benchmark/``. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (the same window; after it a
profiled stage, with the benchmark's spans in ``--trace 1``). The last
line of standard output is the result as one JSON object; the numbers
compared with the reference, each beside its limit, are the last lines
of standard error and the result's last key.

Needs an NVIDIA GPU: with none, or fewer than the cell asks for, it exits
with code 2 and prints no result. It exits with code 3 if a module of
JAX or of the JAX package is imported at the start or at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# transformers, where a library imports it, must not load flax/JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one process with few host threads: the card does the work, and a
# thread pool per core only adds to the host's noise
os.environ.setdefault("OMP_NUM_THREADS", "1")

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    t_start = harness.process_start_wall()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.check_imports("at the start")
    cell = harness.load_cell(args.workload)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                              process_start=t_start)
    harness.check_imports("at the end")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

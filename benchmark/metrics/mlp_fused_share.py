"""100 x the rows of the MLP calls that took the fused route over the rows
of all MLP calls, over the profiled steps: the program's counters
``mlp_rows_fused`` and ``mlp_rows`` (``ngp_tpu_torch/models/mlp.py``,
counted while a profiler records). None where the program counts no MLP
rows (a tree older than the counters)."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters(run)
    if not c.get("mlp_rows"):
        return None
    return 100.0 * c.get("mlp_rows_fused", 0.0) / c["mlp_rows"]

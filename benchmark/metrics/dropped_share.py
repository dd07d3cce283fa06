"""100 x the samples the turbo march dropped (past its crossing slots or
its budget) over those dropped and composited, over the profiled steps:
the program's counters ``samples_dropped`` and ``samples_composited``,
the share ``turbo_overflow`` estimates each step, in the steady regime."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters(run)
    if "samples_dropped" not in c:
        return None
    total = c["samples_dropped"] + c.get("samples_composited", 0.0)
    return 100.0 * c["samples_dropped"] / total if total else None

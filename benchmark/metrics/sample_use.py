"""100 x the samples the render composited over the rows its network
closures evaluated, over the profiled steps: the program's counters
``samples_composited`` and ``samples_evaluated`` (``ngp_tpu_torch/
tracing.py``, counted while a profiler records). The v1 march evaluates
all N x S slots, the turbo march its compact budget."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters(run)
    if not c.get("samples_evaluated"):
        return None
    return 100.0 * c.get("samples_composited", 0.0) / c["samples_evaluated"]

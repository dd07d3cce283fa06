"""Device ms per profiled step of the work launched inside the program's
``ngp/mlp`` spans (``ngp_tpu_torch/ops/kernels/fused_mlp.py``: the bf16
MLPs' fused forward and backward launches), attributed by the launch calls'
correlation (``program_trace.span_device_s``). None where the program
opens no such span: a tree without the fused route, or a cell whose MLPs
do not take it.

``span_device_s`` reads the trace's launch events, which the harness's
``Profile`` does not keep: importing this reader makes the traced stage's
``Profile`` keep its events (``Profile.events``)."""

from benchmark import program_trace, trace


class _KeepsEvents(trace.Profile):
    keeps_events = True

    def __init__(self, events, n_steps, wall_s):
        super().__init__(events, n_steps, wall_s)
        self.events = events


if not getattr(trace.Profile, "keeps_events", False):
    trace.Profile = _KeepsEvents


def read(run):
    p = run.profile
    events = getattr(p, "events", None)
    s = program_trace.span_device_s(events, "mlp") if events else None
    return 1e3 * s / p.n_steps if s else None

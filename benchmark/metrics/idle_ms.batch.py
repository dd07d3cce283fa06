"""Device idle ms a profiled step in the gaps between device work whose
middle falls in the program's ``ngp/batch`` (the step's rays, pixels,
ground truth and ``zero_grad``), a phase of ``ngp/step``
(``program_trace.idle_by_phase``). Split by cell (``.turbo``) where the
cell reports another end-to-end metric."""

from benchmark import program_trace


def read(run):
    return program_trace.idle_ms(run, "batch")

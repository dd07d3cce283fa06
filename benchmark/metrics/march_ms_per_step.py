"""Device ms per profiled step of the work launched inside the march
call (the turbo march or the v1 march, whichever the cell runs)."""

SPANS = [
    {"module": "ngp_tpu_torch.models.occupancy", "attr": "march_rays_turbo", "span": "march"},
    {"module": "ngp_tpu_torch.models.occupancy", "attr": "march_rays", "span": "march"},
]


def read(run):
    p = run.profile
    s = p.span_s("march") if p is not None else None
    return 1e3 * s / p.n_steps if s else None

"""Device kernels, copies and fills per profiled step."""


def read(run):
    p = run.profile
    return len(p.device) / p.n_steps if p is not None and p.device else None

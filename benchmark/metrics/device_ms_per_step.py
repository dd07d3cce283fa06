"""Device ms a training step: the union of the device events' intervals
over the profiled steps (the traffic's ``profiled_steps`` after the
window, a whole number of refresh periods), over their number. The card's
own time a step, without the gaps in which it waits for the host."""

PROFILE = True


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    return 1e3 * p.busy_s / p.n_steps

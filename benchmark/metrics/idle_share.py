"""100 x (1 - device busy / wall) over the profiled steps; busy is the
union of the device events' intervals. The profiler stretches the wall,
so this reads high."""


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)

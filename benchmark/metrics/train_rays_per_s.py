"""Rays of every step completed in the window over the window's seconds
(the window ends in a device sync)."""


def read(run):
    w = run.window
    return w["rays"] / w["seconds"] if w.get("steps") else None

"""The 95th percentile over the window's steps of the interval between
consecutive CUDA events, each recorded after its step (no host sync)."""

import numpy as np


def read(run):
    ms = run.window.get("step_ms")
    return float(np.percentile(ms, 95)) if ms else None

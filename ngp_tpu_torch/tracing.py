"""Spans and counters of the port, on the torch profiler's clock.

While a torch profiler records (``torch.profiler.profile``), ``span(name)``
is a ``record_function`` range named ``ngp/<name>``: it lands in the
profiler's own trace, on the same timeline as the device's events, so a
wait of the device can be put down to the phase of the step that the
host ran meanwhile. Otherwise it is one shared no-op context, and costs a
check of the profiler's flag. ``traced(name)`` makes each call of a
function the span ``name``. The profiler's buffer keeps the spans; its
export writes them out.

``count(name, value)`` appends ``value`` to ``COUNTERS[name]`` while a
profiler records, and does nothing otherwise. ``value`` is a host number
or a device scalar the caller has computed already: a count adds no
launch and no sync. ``counter_totals()`` sums each counter after the
work (one sync a device), ``reset_counters()`` clears them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

PREFIX = "ngp/"
COUNTERS: Dict[str, List] = {}
_OFF = contextlib.nullcontext()


def span(name: str):
    """``ngp/<name>`` as a profiler range while a profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def traced(name: str):
    """A decorator: each call of the function is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a host number or a device scalar) to the counter
    ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        COUNTERS.setdefault(name, []).append(value)


def counter_totals() -> Dict[str, float]:
    """Each counter's sum as a float; reads the device scalars once per device."""
    totals = {name: 0.0 for name in COUNTERS}
    on_device: Dict[torch.device, List] = {}
    for name, values in COUNTERS.items():
        for v in values:
            if torch.is_tensor(v):
                on_device.setdefault(v.device, []).append((name, v))
            else:
                totals[name] += float(v)
    for pairs in on_device.values():
        sums = torch.stack([v.detach().reshape(()).double() for _, v in pairs]).tolist()
        for (name, _), s in zip(pairs, sums):
            totals[name] += s
    return totals


def reset_counters() -> None:
    COUNTERS.clear()

"""Spans and counters the benchmark puts around the port's functions.

A metric file declares what it needs as ``SPANS``, a list of dicts:

- ``module``, ``attr``: the function to wrap, looked up where its callers
  find it (the module whose global the caller reads);
- ``span``: the name of the ``record_function`` range opened around each
  call while the traced stage runs (``bench/<span>`` in the trace);
- ``when(args, kwargs)``: optional, which calls the span and the rest
  cover (others pass through untouched);
- ``capture(args, kwargs, out) -> dict``: optional, what a reader keeps
  of the span's first calls in the traced stage (references, not copies);
- ``counter`` and ``count(args, kwargs, out)``: optional, a number or a
  device scalar added up over the calls of the traced run's window.

Specs for one (module, attr, span) from several metric files merge into
one wrapper.
"""

from __future__ import annotations

import functools
import importlib
from typing import Dict, List

import torch

from benchmark.trace import SPAN_PREFIX


class Instruments:
    def __init__(self, specs: List[dict]):
        merged: Dict[tuple, dict] = {}
        for s in specs:
            key = (s["module"], s["attr"], s["span"])
            merged[key] = {**merged.get(key, {}), **s}
        self.specs = list(merged.values())
        self.profiling = False
        self.counting = False
        self.capture_left: Dict[str, int] = {}
        self.captures: Dict[str, list] = {}
        self.counts: Dict[str, object] = {}
        self._installed = []

    def install(self) -> None:
        by_fn: Dict[tuple, List[dict]] = {}
        for s in self.specs:
            by_fn.setdefault((s["module"], s["attr"]), []).append(s)
        for (mod_name, attr), specs in by_fn.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            fn = orig
            for s in specs:
                fn = self._wrap(fn, s)
            setattr(mod, attr, fn)
            self._installed.append((mod, attr, orig))

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self._installed):
            setattr(mod, attr, orig)
        self._installed = []

    def _wrap(self, fn, spec):
        span, when = spec["span"], spec.get("when")
        capture, count, counter = spec.get("capture"), spec.get("count"), spec.get("counter")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if when is not None and not when(args, kwargs):
                return fn(*args, **kwargs)
            if self.profiling:
                with torch.profiler.record_function(SPAN_PREFIX + span):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if self.counting and count is not None:
                self.counts[counter] = self.counts.get(counter, 0) + count(args, kwargs, out)
            if capture is not None and self.capture_left.get(span, 0) > 0:
                self.capture_left[span] -= 1
                self.captures.setdefault(span, []).append(capture(args, kwargs, out))
            return out

        return wrapper

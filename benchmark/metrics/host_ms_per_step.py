"""Host ms from entry to return of Trainer.step, no sync; the mean over
the traced run's window (before the profiler starts)."""


def read(run):
    h = run.window.get("host_s")
    return 1e3 * sum(h) / len(h) if h else None

"""torch.cuda.max_memory_allocated() over the window (reset once set-up
ends), in MiB."""


def read(run):
    b = run.peak_window_bytes
    return b / 2**20 if b else None

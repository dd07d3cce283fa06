"""Seconds from the process's start to the first timed step: imports,
the kernel build (first run in a checkout only), the scene, the model,
the checked and warm-up steps."""


def read(run):
    return run.setup_s

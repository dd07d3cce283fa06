"""Device ms per profiled step of the cuBLAS matrix-product kernels (the
MLP products outside the fused CP head), matched by name."""

PATTERNS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce", "splitk_reduce")


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    s = p.device_s(lambda name: any(pat in name.lower() for pat in PATTERNS))
    return 1e3 * s / p.n_steps if s else None

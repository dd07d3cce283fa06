"""Real spherical-harmonics basis, degrees 1-8 (``ngp_tpu/ops/sh.py``).

Same Sloan recurrence, Condon-Shortley phase and l^2 + l + m order as
the JAX encoder. The CUDA radiance kernel (``kernels/csrc/cp_kernels.cu``,
``sh_row``) repeats these steps in the same order.
"""

from __future__ import annotations

import math

import torch


def sh_basis_dim(degree: int) -> int:
    return degree * degree


def _double_factorial(n: int) -> int:
    result = 1
    while n > 1:
        result *= n
        n -= 2
    return result


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[..., 3] unit directions -> [..., degree**2] basis values."""
    if not (1 <= degree <= 8):
        raise ValueError(f"sh_encode degree must be in [1, 8], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [None] * (degree * degree)
    one = torch.ones_like(x)
    A, B = one, torch.zeros_like(x)
    for m in range(degree):
        p_prev = one * float(_double_factorial(2 * m - 1))
        p_curr = None
        for l in range(m, degree):
            if l == m:
                p = p_prev
            elif l == m + 1:
                p = (2 * m + 1) * z * p_prev
                p_curr = p
            else:
                p = ((2 * l - 1) * z * p_curr - (l + m - 1) * p_prev) / (l - m)
                p_prev, p_curr = p_curr, p
            k = math.sqrt(
                (2 * l + 1) / (4.0 * math.pi)
                * math.factorial(l - m) / math.factorial(l + m)
            )
            if m == 0:
                out[l * l + l] = k * p
            else:
                c = ((-1.0) ** m) * math.sqrt(2.0) * k
                out[l * l + l + m] = (c * p) * A
                out[l * l + l - m] = (c * p) * B
        A, B = x * A - y * B, x * B + y * A
    return torch.stack(out, dim=-1).to(dirs.dtype)

"""Frequency (positional) encoding (``ngp_tpu/ops/freq.py``)."""

from __future__ import annotations

import torch


def freq_encode_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[..., D] -> [..., D * (1 + 2*degree)] = [x, sin x, cos x, sin 2x, ...].

    Octaves come from the double-angle ladder sin 2a = 2 sin a cos a,
    cos 2a = 1 - 2 sin^2 a, exactly as the JAX encoder and the CP
    kernels compute them; a direct sin(2^k x) differs at degree 6.
    """
    outs = [x]
    if degree > 0:
        s = torch.sin(x)
        c = torch.cos(x)
        outs += [s, c]
        for _ in range(1, degree):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            outs += [s, c]
    return torch.cat(outs, dim=-1)

"""Truncated exponential (``ngp_tpu/ops/activation.py``): the forward is
exp in float32, the gradient is exp of the input clamped to [-15, 15]."""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        safe = torch.exp(torch.clamp(x.float(), -15.0, 15.0))
        return (safe * g.float()).to(x.dtype)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)

"""Bias-free MLP (``ngp_tpu/models/mlp.py``).

The weights are ``[in, out]`` matrices named ``dense_<i>``, the flax
``Dense`` kernel layout and names, so the kernels and
``models.nerf.params_from_jax`` use them without a transpose.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ngp_tpu_torch import tracing
from ngp_tpu_torch.ops.kernels import fused_mlp


def lecun_normal(fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense init: truncated normal (+-2 sigma) with
    variance 1 / fan_in."""
    w = torch.empty((fan_in, fan_out))
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    # 0.8796...: std of a standard normal truncated to [-2, 2]
    return w * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)


class MLP(nn.Module):
    """``num_layers`` Linear layers without bias, ReLU between, no output
    activation. ``compute_dtype`` (e.g. bf16) rounds the input and each
    layer's output to that type; products accumulate in f32. Weights are
    drawn from a CPU generator and placed on ``device``.

    A bf16 chain whose widths the tensor-core kernels take
    (``fused_mlp.fused_route``: 1-8 layers, widths <= 128, shared memory)
    runs its calls on the card through ``fused_mlp.FusedMLP``, the fused
    forward and backward kernels, with the same roundings; every other call
    runs the chain of f32 products and casts (``fused_mlp.mlp_chain``).
    Each call counts its rows under the ``mlp_rows`` counter, and those of
    the fused route under ``mlp_rows_fused`` (``tracing.count``)."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int = 64,
                 num_layers: int = 3,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        # the device type whose calls take FusedMLP; None keeps the chain
        self.fused_device = "cuda" if fused_mlp.fused_route(compute_dtype, dims) else None
        g = generator or torch.Generator().manual_seed(0)
        for i in range(num_layers):
            fan_in = dim_in if i == 0 else dim_hidden
            fan_out = dim_out if i == num_layers - 1 else dim_hidden
            self.register_parameter(
                f"dense_{i}", nn.Parameter(lecun_normal(fan_in, fan_out, g).to(device))
            )

    @property
    def weights(self):
        return tuple(getattr(self, f"dense_{i}") for i in range(self.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = math.prod(x.shape[:-1])
        tracing.count("mlp_rows", rows)
        if x.device.type == self.fused_device:
            tracing.count("mlp_rows_fused", rows)
            y = fused_mlp.FusedMLP.apply(x.reshape(rows, x.shape[-1]), *self.weights)
            return y.reshape(*x.shape[:-1], y.shape[-1])
        return fused_mlp.mlp_chain(x, self.weights, self.compute_dtype or x.dtype)

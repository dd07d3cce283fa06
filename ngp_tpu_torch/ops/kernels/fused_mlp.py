"""Bias-free ReLU MLP chain: the CUDA kernel's wrapper and plain version.

``fused_mlp`` replaces ``ngp_tpu/ops/pallas/fused_mlp.py:fused_mlp``
(the FFMLP analog); the kernel is in ``csrc/mlp_kernels.cu``, whose
header says what bounds it on Hopper. y = W_n . relu(... relu(W_0 . x)):
x and the weights are rounded to bf16, each hidden layer is ReLU'd and
rounded to bf16, products accumulate in f32, and y is f32 [B, D_out].
Chains of widths up to 128 run on the tensor cores, wider ones on the
CUDA cores; the launcher picks the route from the shape. No path of the
package calls it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, int_array, load_library, pointer_array


def _dims(x: torch.Tensor, weights: Sequence[torch.Tensor]):
    """The chain's widths [D_in, D_1, ..., D_out]; ValueError on a
    mismatch, with the JAX function's message."""
    if x.ndim != 2:
        raise ValueError(f"x must be [B, D_in], got {tuple(x.shape)}")
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    for i, w in enumerate(weights):
        if w.ndim != 2 or w.shape[0] != dims[i]:
            raise ValueError(f"weight {i} shape {tuple(w.shape)} != expected in-dim {dims[i]}")
    return dims


def fused_mlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    _dims(x, weights)
    h = x.to(torch.bfloat16).float()
    for i, w in enumerate(weights):
        h = h @ w.to(torch.bfloat16).float()
        if i != len(weights) - 1:
            h = torch.relu(h).to(torch.bfloat16).float()
    return h


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, D_in] f32 or bf16 and 1-8 [D_i, D_{i+1}] weights -> [B, D_out] f32."""
    dims = _dims(x, weights)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for {x.device}")
    if not 1 <= len(weights) <= 8:
        raise ValueError("fused_mlp: 1-8 layers")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"fused_mlp: x must be contiguous f32 or bf16, got {x.dtype}")
    if any(w.device != x.device for w in weights):
        raise ValueError(f"fused_mlp: the weights must be on {x.device}")
    # the kernel reads bf16 weights; they are small, so the cast is cheap
    ws = [w.to(torch.bfloat16).contiguous() for w in weights]
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    lib = load_library()
    route = ctypes.c_int(0)
    err = lib.ngp_fused_mlp(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], pointer_array(ws),
        int_array(dims), len(ws), out.data_ptr(), ctypes.byref(route),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch("fused_mlp", err)
    LAUNCHES["fused_mlp"] += 1
    LAUNCHES["fused_mlp_tc"] += int(route.value > 0)
    return out

"""Bias-free ReLU MLP chain: the CUDA kernels' wrappers and plain versions.

``fused_mlp`` replaces ``ngp_tpu/ops/pallas/fused_mlp.py:fused_mlp``
(the FFMLP analog); the kernels are in ``csrc/mlp_kernels.cu``, whose
header says what bounds them on Hopper. y = W_n . relu(... relu(W_0 . x)):
x and the weights are rounded to bf16, each hidden layer is ReLU'd and
rounded to bf16, products accumulate in f32, and y is f32 [B, D_out].
Chains of widths up to 128 run on the tensor cores, wider ones on the
CUDA cores; the launcher picks the route from the shape.

``FusedMLP`` is ``models.mlp.MLP``'s bf16 chain as an autograd function
(``MLP`` takes it on the card where ``fused_route`` says): its forward is the
tensor-core kernel with y rounded to bf16 (``mlp_bf16_fwd``), its
backward a second kernel (``mlp_bf16_bwd``) that recomputes the forward
from x and returns what autograd of ``MLP.forward``'s chain of f32
products and bf16 casts returns: dH_l in f32 rounded to bf16 and masked
where the layer's ReLU output is 0, dW_l summed in f32 over the rows and
rounded to bf16, dX in x's dtype. Only the order of the f32 sums differs.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, int_array, load_library, pointer_array

# the tensor-core route's limits (csrc/mlp_kernels.cu: kMaxLayers,
# kTcMaxWidth, kMaxSmemBytes)
MAX_LAYERS = 8
TC_MAX_WIDTH = 128
MAX_SMEM_BYTES = 232448


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


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def bwd_smem_bytes(dims: Sequence[int], warps: int = 1) -> int:
    """Shared memory of the backward kernel's block for a chain of widths
    ``dims`` (``mlp_bwd_layout``): the padded bf16 weights twice (forward
    and transposed fragment order) and their f32 gradient sums, the scan's
    list of 32 tiles a warp, and per warp 16-row bf16 tiles of each layer's
    input and output cotangent (rows padded by 8 values)."""
    kp = [_pad16(d) for d in dims]
    elems = sum(a * b for a, b in zip(kp, kp[1:]))
    tile = 16 * sum(a + b + 16 for a, b in zip(kp, kp[1:]))
    return 8 * elems + (132 * warps + 15) // 16 * 16 + warps * 2 * tile


def fused_route(dtype: Optional[torch.dtype], dims: Sequence[int]) -> bool:
    """Whether an ``MLP`` of compute type ``dtype`` and widths ``dims``
    takes ``FusedMLP`` for its calls on the card: bf16, 1-8 layers, every
    width at most 128, and the backward's shared memory holds the chain for
    one warp (the hash cells' 32-64-16 takes 77 KB for eight warps; D-NeRF's
    deformation net, 76-128-128-128-128-3, would take 518 KB for one and
    keeps ``mlp_chain``)."""
    return (dtype == torch.bfloat16 and 1 <= len(dims) - 1 <= MAX_LAYERS
            and max(dims) <= TC_MAX_WIDTH and bwd_smem_bytes(dims) <= MAX_SMEM_BYTES)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_mlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    _dims(x, weights)
    h = x.to(torch.bfloat16).float()
    for i, w in enumerate(weights):
        h = h @ w.to(torch.bfloat16).float()
        if i != len(weights) - 1:
            h = torch.relu(h).to(torch.bfloat16).float()
    return h


def mlp_chain(x: torch.Tensor, weights: Sequence[torch.Tensor], dtype: torch.dtype,
              inputs: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """``MLP.forward``'s chain of compute type ``dtype``: x and each weight
    rounded to ``dtype``, each product in f32 and rounded to ``dtype``, ReLU
    between layers. Appends each layer's input to ``inputs`` where given."""
    h = x.to(dtype)
    for i, w in enumerate(weights):
        if inputs is not None:
            inputs.append(h)
        h = (h.float() @ w.to(dtype).float()).to(dtype)
        if i != len(weights) - 1:
            h = torch.relu(h)
    return h


def mlp_bf16_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, D_in] -> [B, D_out] bf16, as ``MLP.forward`` computes a bf16 chain."""
    _dims(x, weights)
    return mlp_chain(x, weights, torch.bfloat16)


def mlp_bf16_bwd_plain(x: torch.Tensor, weights: Sequence[torch.Tensor], g: torch.Tensor,
                       need_dx: bool = True) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """(dX in x's dtype or None, [dW_l] f32) of ``mlp_bf16_plain`` for the
    output cotangent ``g``: autograd's products of ``MLP.forward``'s graph
    (``mm_mat1_backward``, ``mm_mat2_backward``) and its casts, in order."""
    _dims(x, weights)
    hs: List[torch.Tensor] = []
    mlp_chain(x, weights, torch.bfloat16, hs)
    wf = [w.to(torch.bfloat16).float() for w in weights]
    dy = g.to(torch.bfloat16).float()
    dws: List[torch.Tensor] = [None] * len(weights)
    dx = None
    for l in reversed(range(len(weights))):
        dws[l] = hs[l].float().t().mm(dy).to(torch.bfloat16).float()
        if l == 0 and not need_dx:
            break
        dh = dy.mm(wf[l].t()).to(torch.bfloat16)
        if l == 0:
            dx = dh.to(x.dtype)
        else:
            dy = dh.masked_fill(hs[l] <= 0, 0).float()
    return dx, dws


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_cuda(name: str, x: torch.Tensor, weights: Sequence[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"{name}: 1-{MAX_LAYERS} layers")
    if any(w.device != x.device for w in weights):
        raise ValueError(f"{name}: the weights must be on {x.device}")


def _weight_args(weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The weights as the kernels read them: contiguous f32, which they
    round to bf16 as they stage them (a bf16 weight's values are kept)."""
    return [w.float().contiguous() for w in weights]


def _launch_fwd(name: str, x: torch.Tensor, weights: Sequence[torch.Tensor],
                out_dtype: torch.dtype) -> torch.Tensor:
    dims = _dims(x, weights)
    _check_cuda(name, x, weights)
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous f32 or bf16, got {x.dtype}")
    ws = _weight_args(weights)
    out = torch.empty((x.shape[0], dims[-1]), dtype=out_dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    lib = load_library()
    route = ctypes.c_int(0)
    err = lib.ngp_fused_mlp(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], pointer_array(ws),
        int_array(dims), len(ws), out.data_ptr(), int(out_dtype == torch.bfloat16),
        ctypes.byref(route), torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(name, err)
    LAUNCHES["fused_mlp"] += 1
    LAUNCHES["fused_mlp_tc"] += int(route.value > 0)
    return out


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, D_in] f32 or bf16 and 1-8 [D_i, D_{i+1}] weights -> [B, D_out] f32."""
    _dims(x, weights)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights)
    return _launch_fwd("fused_mlp", x, weights, torch.float32)


def mlp_bf16_fwd(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, D_in] and 1-8 [D_i, D_{i+1}] weights -> [B, D_out] bf16, the
    last layer rounded to bf16 as ``MLP.forward`` rounds it."""
    _dims(x, weights)
    if x.device.type == "cpu":
        return mlp_bf16_plain(x, weights)
    with tracing.span("mlp"):
        return _launch_fwd("mlp_bf16_fwd", x, weights, torch.bfloat16)


def mlp_bf16_bwd(x: torch.Tensor, weights: Sequence[torch.Tensor], g: torch.Tensor,
                 need_dx: bool = True) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """(dX or None, [dW_l]) of ``mlp_bf16_fwd`` for the cotangent g [B,
    D_out]: x and g bf16 on the card; dX bf16, dW f32 (bf16 values)."""
    dims = _dims(x, weights)
    if x.device.type == "cpu":
        return mlp_bf16_bwd_plain(x, weights, g, need_dx)
    _check_cuda("mlp_bf16_bwd", x, weights)
    B = x.shape[0]
    for name, t, d in (("x", x, dims[0]), ("g", g, dims[-1])):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.shape != (B, d):
            raise ValueError(f"mlp_bf16_bwd: {name} must be contiguous bf16 [{B}, {d}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if g.device != x.device:
        raise ValueError(f"mlp_bf16_bwd: g must be on {x.device}")
    ws = _weight_args(weights)
    sizes = [a * b for a, b in zip(dims, dims[1:])]
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty((B, dims[0]), dtype=torch.bfloat16, device=x.device) if need_dx else None
    with tracing.span("mlp"):
        err = load_library().ngp_fused_mlp_bwd(
            x.data_ptr(), B, pointer_array(ws), int_array(dims), len(ws), g.data_ptr(),
            dx.data_ptr() if dx is not None else None, dw.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check_launch("mlp_bf16_bwd", err)
    LAUNCHES["fused_mlp_bwd"] += int(B > 0)
    dws = [v.view(a, b) for v, a, b in zip(dw.split(sizes), dims, dims[1:])]
    return dx, dws


class FusedMLP(torch.autograd.Function):
    """y = ``mlp_bf16_fwd(x, weights)`` with ``mlp_bf16_bwd`` as its
    backward. Saves x (bf16) and the weights; the backward recomputes the
    activations."""

    @staticmethod
    def forward(ctx, x, *weights):
        xb = x.to(torch.bfloat16).contiguous()
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(xb, *weights)
        return mlp_bf16_fwd(xb, weights)

    @staticmethod
    def backward(ctx, g):
        xb, *weights = ctx.saved_tensors
        dx, dws = mlp_bf16_bwd(xb, weights, g.to(torch.bfloat16).contiguous(),
                               ctx.needs_input_grad[0])
        return ((dx.to(ctx.x_dtype) if dx is not None else None),
                *(dw.to(w.dtype) if need else None
                  for dw, w, need in zip(dws, weights, ctx.needs_input_grad[1:])))

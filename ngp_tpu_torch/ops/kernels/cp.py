"""CP factor-bank encoder and heads: the CUDA kernels' wrappers and
plain versions.

``cp_encode_fwd`` replaces the forward of
``ngp_tpu/ops/pallas/cp_kernels.py:cp_encode`` (the CP features alone),
``cp_density_fwd`` the forward of ``cp_kernels.py:cp_density``,
``cp_bwd_banks`` the factor backward ``_cp_bwd_banks`` that both share,
and ``cp_sigma_rgb`` replaces ``cp_kernels.py:cp_sigma_rgb``; the
kernels are in ``csrc/cp_kernels.cu``, whose header says what bounds
them on Hopper. ``CPEncode`` is ``cp_encode`` with its custom VJP, the
factor gradient through ``cp_bwd_banks``. ``CPDensity`` is
``cp_density`` with its custom VJP: the forward kernel writes the
feats/h1 residuals, and the backward runs the MLP products as f32
matmuls (XLA ran them outside any Pallas kernel) and the factor
gradient through ``cp_bwd_banks``.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors; anything the kernel does not take raises.

Rounding: with bf16 weights, features are rounded to bf16 before w1,
h1 after its ReLU, the SH basis and the geo features before the color
MLP, and each color hidden layer, as the Pallas kernels do; products
accumulate in f32. Both versions lerp the factor lines in f32, as the
JAX CPU reference does (the Pallas kernels build bf16 lerp weights).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ngp_tpu_torch.ops.freq import freq_encode
from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import (
    check_launch,
    int_array,
    load_library,
    pointer_array,
)
from ngp_tpu_torch.ops.sh import sh_encode

_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _lerp(p_ax: torch.Tensor, line: torch.Tensor, res: int):
    """One axis of one bank at positions [M] in [0, 1]: the lower tap
    i0 [M], the weight w [M, 1] of tap i0 + 1, and the f32 lerped line
    values [M, R]."""
    pa = p_ax * (res - 1)
    i0 = torch.clamp(torch.floor(pa), max=res - 2).long()
    w = (pa - i0)[:, None]
    line = line.float()
    return i0, w, line[i0] * (1 - w) + line[i0 + 1] * w


def cp_features_plain(
    pos: torch.Tensor, factors: Sequence[torch.Tensor], resolutions: Sequence[int]
) -> torch.Tensor:
    """[M, 3] -> [M, nb*R] f32 CP features, zero outside [0, 1]^3
    (``cp_encode_reference`` plus the out-of-box mask)."""
    pos = pos.float()
    p = pos.clamp(0.0, 1.0)
    outs = []
    for fb, res in zip(factors, resolutions):
        acc = None
        for ax in range(3):
            _, _, v = _lerp(p[:, ax], fb[ax], res)
            acc = v if acc is None else acc * v
        outs.append(acc)
    cp = torch.cat(outs, dim=-1)
    oob = ((pos < 0.0) | (pos > 1.0)).any(dim=-1)
    return torch.where(oob[:, None], torch.zeros((), device=cp.device), cp)


def cp_encode_plain(pos, factors, resolutions, out_dtype=torch.float32) -> torch.Tensor:
    """[M, 3] -> [M, nb*R] CP features in ``out_dtype``, zero outside
    [0, 1]^3: the f32 features rounded once. Differentiable by autograd
    (the JAX CPU branch of cpgrid_encode)."""
    return cp_features_plain(pos, factors, resolutions).to(out_dtype)


def cp_density_plain(pos, factors, w1, w2, resolutions, freq_degree,
                     residuals: bool = False):
    """[M, 3] -> [M, OUT] f32 = relu(feats @ w1) @ w2; with
    ``residuals`` also feats [M, D] and h1 [M, H1] in the weight dtype.
    Differentiable by autograd (the JAX CPU branch of cpgrid_density)."""
    dt = w1.dtype
    cp = cp_features_plain(pos, factors, resolutions)
    fr = freq_encode(2.0 * pos.float() - 1.0, freq_degree)
    feats = torch.cat([cp, fr], dim=-1).to(dt)
    h1 = torch.relu(feats.float() @ w1.float()).to(dt)
    out = h1.float() @ w2.float()
    return (out, feats, h1) if residuals else out


def cp_bwd_banks_plain(pos, factors, g_cp, resolutions):
    """Factor gradients of the CP features: per bank [3, res, R] in the
    factor dtype from g_cp [M, >= nb*R] (columns b*R.. of bank b). Each
    row adds (1 - w) * others at i0 and w * others at i0 + 1 of each
    axis, others = g * the other two axes' lerped values (f32); rows
    outside [0, 1]^3 add nothing."""
    pos = pos.float()
    p = pos.clamp(0.0, 1.0)
    oob = ((pos < 0.0) | (pos > 1.0)).any(dim=-1)
    rank = factors[0].shape[-1]
    out = []
    for b, (fb, res) in enumerate(zip(factors, resolutions)):
        g = g_cp[:, b * rank:(b + 1) * rank].float()
        g = torch.where(oob[:, None], torch.zeros((), device=g.device), g)
        taps = [_lerp(p[:, ax], fb[ax], res) for ax in range(3)]
        acc = torch.zeros((3, res, rank), dtype=torch.float32, device=g.device)
        for ax, (i0, w, _) in enumerate(taps):
            a, c = [x for x in range(3) if x != ax]
            others = g * taps[a][2] * taps[c][2]
            acc[ax].index_add_(0, i0, (1 - w) * others)
            acc[ax].index_add_(0, i0 + 1, w * others)
        out.append(acc.to(fb.dtype))
    return tuple(out)


def cp_sigma_rgb_plain(pos, dirs, factors, w1, w2, color_ws, resolutions,
                       freq_degree, sh_degree):
    """[M, 3] pos + [M, 3] unit dirs -> [M, 4] f32 (sigma, r, g, b)."""
    dt = w1.dtype
    h = cp_density_plain(pos, factors, w1, w2, resolutions, freq_degree)
    sigma = torch.exp(h[:, :1])
    c = torch.cat(
        [sh_encode(dirs.float(), sh_degree).to(dt), h[:, 1:].to(dt)], dim=-1
    ).float()
    for i, w in enumerate(color_ws):
        c = c @ w.float()
        if i != len(color_ws) - 1:
            c = torch.relu(c).to(dt).float()
    return torch.cat([sigma, torch.sigmoid(c)], dim=-1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_rows(name: str, t: torch.Tensor, M: int, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: needs f32 on {device}, got {t.dtype} on {t.device}")
    if t.shape != (M, 3) or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous [{M}, 3] tensor, got {tuple(t.shape)}")


def _check_banks(name, pos, factors, resolutions) -> Tuple[int, torch.dtype, int]:
    """pos [M, 3] f32 and 1-8 contiguous factor banks [3, res, R] of one
    dtype (f32 or bf16) on pos's device -> (M, factor dtype, R)."""
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"{name}: pos must be [M, 3], got {tuple(pos.shape)}")
    M = pos.shape[0]
    dev = pos.device
    _check_rows(f"{name} pos", pos, M, dev)
    # the kernels count rows, and a row's first position (3 * row), in an int
    # (ctypes would wrap a larger count without a word); they address the
    # rows of features, residuals and g with 64-bit offsets, so [M, D]
    # tensors past 2^31 elements are fine
    if 3 * M >= 2**31:
        raise ValueError(f"{name}: {M} rows are more than the kernels' int row arithmetic "
                         "reaches")
    if len(factors) != len(resolutions) or not 1 <= len(factors) <= 8:
        raise ValueError(f"{name}: 1-8 factor banks, one per resolution")
    dt = factors[0].dtype
    rank = factors[0].shape[-1]
    for f, res in zip(factors, resolutions):
        if tuple(f.shape) != (3, res, rank) or res < 2:
            raise ValueError(f"{name}: factor bank {tuple(f.shape)} is not [3, {res}, {rank}]")
        if f.device != dev or f.dtype != dt or dt not in _DTYPES or not f.is_contiguous():
            raise ValueError(f"{name}: factors must be contiguous f32 or bf16 "
                             f"of one dtype on {dev}")
    return M, dt, rank


def _check_weights(name, pos, factors, w1, w2, resolutions, freq_degree,
                   extra=()) -> Tuple[int, int, int, int]:
    M, dt, rank = _check_banks(name, pos, factors, resolutions)
    D, H1 = w1.shape
    if D != len(factors) * rank + 3 * (1 + 2 * freq_degree):
        raise ValueError(f"{name}: w1 has {D} rows, the features have a different width")
    if w2.ndim != 2 or w2.shape[0] != H1:
        raise ValueError(f"{name}: w2 {tuple(w2.shape)} does not follow w1 {tuple(w1.shape)}")
    for t in (w1, w2, *extra):
        if t.device != pos.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: factors and weights must be contiguous {dt} on {pos.device}"
            )
    return M, rank, D, H1


def cp_density_fwd(pos, factors, w1, w2, resolutions, freq_degree,
                   residuals: bool = False):
    """Fused density head forward: [M, 3] f32 in [0, 1] -> [M, OUT] f32.

    factors: [3, res_b, R] per bank; w1 [nb*R + freq_dim, H1], w2
    [H1, OUT]; all f32 or all bf16 (the MLP compute type). Rows outside
    [0, 1]^3 get zero CP features but keep their freq columns. With
    ``residuals`` returns (out, feats [M, D], h1 [M, H1]), the last two
    in the weight dtype: the values the kernel multiplied. bf16 runs
    both products on the tensor cores for H1 up to 256 (tiles of 128, 64
    or 32 rows) and on the CUDA cores above; f32 runs them on the CUDA
    cores in full f32. The kernel picks its route from the shape."""
    if pos.device.type == "cpu":
        return cp_density_plain(pos, factors, w1, w2, resolutions, freq_degree,
                                residuals)
    if pos.device.type != "cuda":
        raise ValueError(f"cp_density_fwd: no kernel for {pos.device}")
    M, rank, D, H1 = _check_weights(
        "cp_density_fwd", pos, factors, w1, w2, resolutions, freq_degree
    )
    lib = load_library()
    bf16 = w1.dtype == torch.bfloat16
    OUT = w2.shape[1]
    out = torch.empty((M, OUT), dtype=torch.float32, device=pos.device)
    feats = h1 = None
    if residuals:
        feats = torch.empty((M, D), dtype=w1.dtype, device=pos.device)
        h1 = torch.empty((M, H1), dtype=w1.dtype, device=pos.device)
    route = ctypes.c_int(0)
    # called for M = 0 too, so a shape the kernel does not take raises alike
    err = lib.ngp_cp_density_fwd(
        pos.data_ptr(), M, pointer_array(factors), int_array(resolutions),
        len(factors), rank, freq_degree, w1.data_ptr(), w2.data_ptr(),
        D, H1, OUT, int(bf16), out.data_ptr(),
        feats.data_ptr() if residuals else None,
        h1.data_ptr() if residuals else None, ctypes.byref(route),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    check_launch("cp_density_fwd", err)
    if M > 0:
        LAUNCHES["cp_density_fwd"] += 1
        LAUNCHES["cp_density_fwd_residuals"] += int(residuals)
        LAUNCHES["cp_density_fwd_tc"] += int(route.value > 0)
    return (out, feats, h1) if residuals else out


def cp_encode_fwd(pos, factors, resolutions, out_dtype=torch.float32) -> torch.Tensor:
    """CP features: [M, 3] f32 -> [M, nb*R] in ``out_dtype`` (f32 or
    bf16), zero for rows outside [0, 1]^3; factors [3, res_b, R] per
    bank, all f32 or all bf16, lerped in f32."""
    if pos.device.type == "cpu":
        return cp_encode_plain(pos, factors, resolutions, out_dtype)
    if pos.device.type != "cuda":
        raise ValueError(f"cp_encode_fwd: no kernel for {pos.device}")
    M, dt, rank = _check_banks("cp_encode_fwd", pos, factors, resolutions)
    if out_dtype not in _DTYPES:
        raise ValueError(f"cp_encode_fwd: the output must be f32 or bf16, not {out_dtype}")
    out = torch.empty((M, len(factors) * rank), dtype=out_dtype, device=pos.device)
    if M > 0:
        lib = load_library()
        err = lib.ngp_cp_encode_fwd(
            pos.data_ptr(), M, pointer_array(factors), int_array(resolutions), len(factors),
            rank, int(dt == torch.bfloat16), int(out_dtype == torch.bfloat16),
            out.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream,
        )
        check_launch("cp_encode_fwd", err)
        LAUNCHES["cp_encode_fwd"] += 1
    return out


def cp_bwd_banks(pos, factors, g_cp, resolutions):
    """Factor gradients from d(CP features): pos [M, 3] f32, g_cp
    [M, >= nb*R] f32 (row stride free, columns contiguous) -> per bank
    [3, res, R] in the factor dtype, accumulated in f32. Rows outside
    [0, 1]^3 add nothing. The kernel reads 4 columns of g and of each
    factor line by one vector access where the rank, g's row stride and
    the banks allow it (the backward passes a contiguous [M, nb*R] g),
    else column by column. The banks' gradients are views of one
    allocation."""
    if pos.device.type == "cpu":
        return cp_bwd_banks_plain(pos, factors, g_cp, resolutions)
    if pos.device.type != "cuda":
        raise ValueError(f"cp_bwd_banks: no kernel for {pos.device}")
    M, dt, rank = _check_banks("cp_bwd_banks", pos, factors, resolutions)
    dev = pos.device
    nbR = len(factors) * rank
    if (g_cp.device != dev or g_cp.dtype != torch.float32 or g_cp.ndim != 2
            or g_cp.shape[0] != M or g_cp.shape[1] < nbR
            or (M > 1 and g_cp.stride(1) != 1) or g_cp.stride(0) < nbR):
        raise ValueError(f"cp_bwd_banks: g_cp must be f32 [{M}, >= {nbR}] on {dev} "
                         "with contiguous columns")
    sizes = [3 * r * rank for r in resolutions]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    if M > 0:
        lib = load_library()
        err = lib.ngp_cp_bwd_banks(
            pos.data_ptr(), M, g_cp.data_ptr(), g_cp.stride(0), pointer_array(factors),
            int_array(resolutions), len(factors), rank, int(dt == torch.bfloat16),
            acc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        check_launch("cp_bwd_banks", err)
        LAUNCHES["cp_bwd_banks"] += 1
    return tuple(a.view(3, r, rank) for a, r in zip(acc.to(dt).split(sizes), resolutions))


class CPEncode(torch.autograd.Function):
    """``cp_encode`` with its custom VJP: the factor gradients through
    ``cp_bwd_banks`` from the f32 cotangent, and zero d(pos)."""

    @staticmethod
    def forward(ctx, pos, resolutions, out_dtype, *factors):
        ctx.save_for_backward(pos, *factors)
        ctx.resolutions = tuple(resolutions)
        return cp_encode_fwd(pos, factors, resolutions, out_dtype)

    @staticmethod
    def backward(ctx, g):
        pos, *factors = ctx.saved_tensors
        dfactors = cp_bwd_banks(pos, factors, g.float().contiguous(), ctx.resolutions)
        dpos = torch.zeros_like(pos) if ctx.needs_input_grad[0] else None
        return (dpos, None, None, *dfactors)


def cp_encode(pos, factors, resolutions, out_dtype=torch.float32):
    """CP features, differentiable in the factors: ``CPEncode`` while
    autograd records, the forward launch alone otherwise."""
    if torch.is_grad_enabled() and any(f.requires_grad for f in factors):
        return CPEncode.apply(pos, tuple(resolutions), out_dtype, *factors)
    return cp_encode_fwd(pos, factors, resolutions, out_dtype)


def cp_density_bwd(g, pos, factors, w1, w2, feats, h1, resolutions):
    """``_cp_density_bwd``: (dfactors, dW1, dW2) from d(out) g [M, OUT].

    The MLP products take f32 from the weight-dtype residuals, with dh1
    rounded to the weight dtype before both products it feeds, as the
    JAX backward does; dW1 and dW2 come back in the weight dtype. The
    f32 products are exact f32 at PyTorch's default matmul precision
    ("highest", no TF32)."""
    nbR = len(resolutions) * factors[0].shape[-1]
    g = g.float()
    h1f = h1.float()
    dW2 = h1f.t() @ g
    dh1 = torch.where(h1 > 0, g @ w2.float().t(), torch.zeros((), device=g.device))
    dh1 = dh1.to(w1.dtype).float()
    dW1 = feats.float().t() @ dh1
    # d(CP features) alone: d(pos) is zero, so the freq columns are not
    # needed, and g_cp is a contiguous [M, nb*R] (16-byte rows at R % 4 == 0)
    g_cp = dh1 @ w1[:nbR].float().t()
    dfactors = cp_bwd_banks(pos, factors, g_cp, resolutions)
    return dfactors, dW1.to(w1.dtype), dW2.to(w2.dtype)


class CPDensity(torch.autograd.Function):
    """``cp_density`` with its custom VJP; d(pos) is zero, as in JAX
    (march sample positions are not differentiated)."""

    @staticmethod
    def forward(ctx, pos, w1, w2, resolutions, freq_degree, *factors):
        out, feats, h1 = cp_density_fwd(pos, factors, w1, w2, resolutions, freq_degree,
                                        residuals=True)
        ctx.save_for_backward(pos, w1, w2, feats, h1, *factors)
        ctx.resolutions = tuple(resolutions)
        return out

    @staticmethod
    def backward(ctx, g):
        pos, w1, w2, feats, h1, *factors = ctx.saved_tensors
        dfactors, dW1, dW2 = cp_density_bwd(g, pos, factors, w1, w2, feats, h1,
                                            ctx.resolutions)
        return (None, dW1, dW2, None, None, *dfactors)


def cp_density(pos, factors, w1, w2, resolutions, freq_degree):
    """Fused density head, differentiable in factors, w1 and w2: the
    residual-writing launch and ``CPDensity`` while autograd records,
    the residual-free launch otherwise (grid refresh, eval)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w1, w2, *factors)):
        return CPDensity.apply(pos, w1, w2, tuple(resolutions), freq_degree, *factors)
    return cp_density_fwd(pos, factors, w1, w2, resolutions, freq_degree)


def cp_sigma_rgb(pos, dirs, factors, w1, w2, color_ws, resolutions,
                 freq_degree, sh_degree):
    """Fused eval radiance: [M, 3] pos in [0, 1] + [M, 3] unit dirs ->
    [M, 4] f32 rows (exp(sigma_raw), sigmoid(rgb)). color_ws: the
    bias-free color MLP kernels, [sh_degree**2 + OUT - 1, H] ... [H, 3].

    bf16 runs every product on the tensor cores where the widths allow
    (H1 <= 256, color hidden layers <= 64) and on the CUDA cores
    otherwise; f32 on the CUDA cores."""
    if pos.device.type == "cpu":
        return cp_sigma_rgb_plain(pos, dirs, factors, w1, w2, color_ws,
                                  resolutions, freq_degree, sh_degree)
    if pos.device.type != "cuda":
        raise ValueError(f"cp_sigma_rgb: no kernel for {pos.device}")
    M, rank, D, H1 = _check_weights(
        "cp_sigma_rgb", pos, factors, w1, w2, resolutions, freq_degree,
        extra=tuple(color_ws),
    )
    _check_rows("cp_sigma_rgb dirs", dirs, M, pos.device)
    OUT = w2.shape[1]
    if not 1 <= len(color_ws) <= 4 or not 1 <= sh_degree <= 8:
        raise ValueError("cp_sigma_rgb: 1-4 color layers and SH degree 1-8")
    dims = [color_ws[0].shape[0]] + [w.shape[1] for w in color_ws]
    chain = all(
        color_ws[i].shape[1] == color_ws[i + 1].shape[0]
        for i in range(len(color_ws) - 1)
    )
    if dims[0] != sh_degree**2 + OUT - 1 or dims[-1] != 3 or not chain:
        raise ValueError(f"cp_sigma_rgb: color layer widths {dims} do not fit")
    out = torch.empty((M, 4), dtype=torch.float32, device=pos.device)
    if M == 0:
        return out
    lib = load_library()
    route = ctypes.c_int(0)
    err = lib.ngp_cp_sigma_rgb(
        pos.data_ptr(), dirs.data_ptr(), M, pointer_array(factors),
        int_array(resolutions), len(factors), rank, freq_degree,
        w1.data_ptr(), w2.data_ptr(), D, H1, OUT, pointer_array(color_ws),
        int_array(dims), len(color_ws), sh_degree,
        int(w1.dtype == torch.bfloat16), out.data_ptr(), ctypes.byref(route),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    check_launch("cp_sigma_rgb", err)
    LAUNCHES["cp_sigma_rgb"] += 1
    LAUNCHES["cp_sigma_rgb_tc"] += int(route.value > 0)
    return out

"""CP factor-bank heads: the CUDA kernels' wrappers and plain versions.

``cp_density_fwd`` replaces the forward of
``ngp_tpu/ops/pallas/cp_kernels.py:cp_density`` and ``cp_sigma_rgb``
replaces ``cp_kernels.py:cp_sigma_rgb``; the kernels are in
``csrc/cp_kernels.cu``, whose header says what bounds them on Hopper.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors; anything the kernel does not take raises.

Rounding: with bf16 weights, features are rounded to bf16 before w1,
h1 after its ReLU, the SH basis and the geo features before the color
MLP, and each color hidden layer, as the Pallas kernels do; products
accumulate in f32. Both versions lerp the factor lines in f32, as the
JAX CPU reference does (the Pallas kernels build bf16 lerp weights).
"""

from __future__ import annotations

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
            pa = p[:, ax] * (res - 1)
            i0 = torch.clamp(torch.floor(pa), max=res - 2).long()
            w = (pa - i0)[:, None]
            line = fb[ax].float()
            v = line[i0] * (1 - w) + line[i0 + 1] * w
            acc = v if acc is None else acc * v
        outs.append(acc)
    cp = torch.cat(outs, dim=-1)
    oob = ((pos < 0.0) | (pos > 1.0)).any(dim=-1)
    return torch.where(oob[:, None], torch.zeros((), device=cp.device), cp)


def cp_density_plain(pos, factors, w1, w2, resolutions, freq_degree):
    """[M, 3] -> [M, OUT] f32 = relu(feats @ w1) @ w2."""
    dt = w1.dtype
    cp = cp_features_plain(pos, factors, resolutions)
    fr = freq_encode(2.0 * pos.float() - 1.0, freq_degree)
    feats = torch.cat([cp, fr], dim=-1).to(dt).float()
    h1 = torch.relu(feats @ w1.float()).to(dt).float()
    return h1 @ w2.float()


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


def _check_weights(name, pos, factors, w1, w2, resolutions, freq_degree,
                   extra=()) -> Tuple[int, int, int, int]:
    dev = pos.device
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"{name}: pos must be [M, 3], got {tuple(pos.shape)}")
    M = pos.shape[0]
    _check_rows(f"{name} pos", pos, M, dev)
    if len(factors) != len(resolutions) or not 1 <= len(factors) <= 8:
        raise ValueError(f"{name}: 1-8 factor banks, one per resolution")
    dt = w1.dtype
    if dt not in _DTYPES:
        raise ValueError(f"{name}: weights must be f32 or bf16, got {dt}")
    rank = factors[0].shape[-1]
    for f, res in zip(factors, resolutions):
        if tuple(f.shape) != (3, res, rank) or res < 2:
            raise ValueError(f"{name}: factor bank {tuple(f.shape)} is not [3, {res}, {rank}]")
    D, H1 = w1.shape
    if D != len(factors) * rank + 3 * (1 + 2 * freq_degree):
        raise ValueError(f"{name}: w1 has {D} rows, the features have a different width")
    if w2.ndim != 2 or w2.shape[0] != H1:
        raise ValueError(f"{name}: w2 {tuple(w2.shape)} does not follow w1 {tuple(w1.shape)}")
    for t in (*factors, w1, w2, *extra):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: factors and weights must be contiguous {dt} on {dev}"
            )
    return M, rank, D, H1


def cp_density_fwd(pos, factors, w1, w2, resolutions, freq_degree):
    """Fused density head forward: [M, 3] f32 in [0, 1] -> [M, OUT] f32.

    factors: [3, res_b, R] per bank; w1 [nb*R + freq_dim, H1], w2
    [H1, OUT]; all f32 or all bf16 (the MLP compute type). Rows outside
    [0, 1]^3 get zero CP features but keep their freq columns."""
    if pos.device.type == "cpu":
        return cp_density_plain(pos, factors, w1, w2, resolutions, freq_degree)
    if pos.device.type != "cuda":
        raise ValueError(f"cp_density_fwd: no kernel for {pos.device}")
    M, rank, D, H1 = _check_weights(
        "cp_density_fwd", pos, factors, w1, w2, resolutions, freq_degree
    )
    OUT = w2.shape[1]
    out = torch.empty((M, OUT), dtype=torch.float32, device=pos.device)
    if M == 0:
        return out
    lib = load_library()
    err = lib.ngp_cp_density_fwd(
        pos.data_ptr(), M, pointer_array(factors), int_array(resolutions),
        len(factors), rank, freq_degree, w1.data_ptr(), w2.data_ptr(),
        D, H1, OUT, int(w1.dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    check_launch("cp_density_fwd", err)
    LAUNCHES["cp_density_fwd"] += 1
    return out


def cp_sigma_rgb(pos, dirs, factors, w1, w2, color_ws, resolutions,
                 freq_degree, sh_degree):
    """Fused eval radiance: [M, 3] pos in [0, 1] + [M, 3] unit dirs ->
    [M, 4] f32 rows (exp(sigma_raw), sigmoid(rgb)). color_ws: the
    bias-free color MLP kernels, [sh_degree**2 + OUT - 1, H] ... [H, 3]."""
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
    err = lib.ngp_cp_sigma_rgb(
        pos.data_ptr(), dirs.data_ptr(), M, pointer_array(factors),
        int_array(resolutions), len(factors), rank, freq_degree,
        w1.data_ptr(), w2.data_ptr(), D, H1, OUT, pointer_array(color_ws),
        int_array(dims), len(color_ws), sh_degree,
        int(w1.dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    check_launch("cp_sigma_rgb", err)
    LAUNCHES["cp_sigma_rgb"] += 1
    return out

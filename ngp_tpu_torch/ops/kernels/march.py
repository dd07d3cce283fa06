"""Coarse occupancy lookup of the turbo march: the CUDA kernel's wrapper
and its plain version.

``coarse_lookup_bits`` replaces
``ngp_tpu/ops/pallas/march_kernels.py:coarse_lookup_bits``; the kernel
is in ``csrc/march_kernels.cu``, whose header says what bounds it.
"""

from __future__ import annotations

import torch

from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, load_library


def coarse_lookup_plain(payload: torch.Tensor, flatcell: torch.Tensor) -> torch.Tensor:
    """Bit ``fc & 7`` of byte ``payload.flat[fc >> 3]``; cells past the
    payload read as empty (``ngp_tpu/models/occupancy.py:_coarse_lookup``)."""
    flat = payload.reshape(-1)
    n_bytes = flat.shape[0]
    byte_idx = flatcell >> 3
    inside = (flatcell >= 0) & (byte_idx < n_bytes)
    byte = flat[byte_idx.clamp(0, n_bytes - 1).long()].to(torch.int32)
    return (((byte >> (flatcell & 7)) & 1) > 0) & inside


def coarse_lookup_bits(payload: torch.Tensor, flatcell: torch.Tensor) -> torch.Tensor:
    """Occupancy bit of each flat coarse-cell id.

    payload : [R, 128] f32 byte values (``pack_occupancy_payloads``)
    flatcell: int32, any shape, ids in [0, R*1024)
    returns : bool, the shape of ``flatcell``
    """
    if flatcell.device.type == "cpu":
        return coarse_lookup_plain(payload, flatcell)
    if flatcell.device.type != "cuda":
        raise ValueError(f"coarse_lookup_bits: no kernel for {flatcell.device}")
    if payload.device != flatcell.device or payload.dtype != torch.float32:
        raise ValueError("coarse_lookup_bits: payload must be f32 on the flatcell's device")
    if payload.ndim != 2 or payload.shape[1] != 128 or not payload.is_contiguous():
        raise ValueError(f"coarse_lookup_bits: payload must be contiguous [R, 128], "
                         f"got {tuple(payload.shape)}")
    if flatcell.dtype != torch.int32 or not flatcell.is_contiguous():
        raise ValueError("coarse_lookup_bits: flatcell must be contiguous int32")
    out = torch.empty(flatcell.shape, dtype=torch.bool, device=flatcell.device)
    n = flatcell.numel()
    if n == 0:
        return out
    lib = load_library()
    err = lib.ngp_coarse_lookup_bits(
        payload.data_ptr(), payload.numel(), flatcell.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(flatcell.device).cuda_stream,
    )
    check_launch("coarse_lookup_bits", err)
    LAUNCHES["coarse_lookup_bits"] += 1
    return out

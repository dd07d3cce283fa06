"""Collectives over the mesh's axes (``ngp_tpu/parallel/collectives.py``).

The JAX package writes ``psum`` / ``all_gather`` under ``shard_map`` and
leaves the training collectives to XLA; here the trainers call them:

- ``eval_metrics_dp`` and ``gather_predictions_dp``: JAX's eval
  aggregation, an ``all_reduce(SUM)`` and a tiled ``all_gather`` over
  ``data``;
- ``gather_cp_features``: the all-gather of the model ranks' CP feature
  columns before the sigma MLP, an autograd function whose backward
  hands each rank its own columns of the cotangent;
- ``sync_gradients``: the mean of the gradients over ``data``, one
  flat buffer a dtype;
- ``data_sum`` and ``rank_budget``: a train step's counters, and a data
  rank's share of the batch-wide sample budget of the turbo march.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.distributed as dist

from ngp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_rank, axis_size


def eval_metrics_dp(mesh, pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """MSE and PSNR over rays split across ``data``: pred / gt [n, C] are
    this data rank's rows; the squared-error sum and the count are summed
    over the data ranks (JAX's ``psum``), so the ranks may hold unequal
    shares. Returns {"mse", "psnr"} scalars, equal on every rank."""
    se = torch.sum((pred.float() - gt.float()) ** 2)
    buf = torch.stack([se, torch.tensor(float(pred.numel()), device=se.device)])
    dist.all_reduce(buf, group=mesh.get_group(DATA_AXIS))
    mse = buf[0] / buf[1]
    return {"mse": mse, "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12))}


def gather_predictions_dp(mesh, x: torch.Tensor) -> torch.Tensor:
    """This data rank's rows [n, ...] -> the data ranks' rows in rank
    order [D n, ...], on every rank (JAX's tiled ``all_gather`` on axis 0)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, DATA_AXIS))]
    dist.all_gather(parts, x, group=mesh.get_group(DATA_AXIS))
    return torch.cat(parts, dim=0)


def data_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the data ranks (a copy; x is kept)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.get_group(DATA_AXIS))
    return x


class _GatherFeatures(torch.autograd.Function):
    """[B, nb * w] bank-major columns of this model rank -> [B, nb * M * w],
    the whole banks' columns in bank-major order (``cp_encode_fwd``'s
    layout). The backward returns this rank's columns of the cotangent and
    sums nothing: every model rank of a data group runs the sigma MLP on
    the same gathered features and so holds the same cotangent (a
    reduce-scatter would count it M times)."""

    @staticmethod
    def forward(ctx, feats, n_banks: int, group, rank: int, size: int):
        B, cols = feats.shape
        w = cols // n_banks
        parts = [torch.empty_like(feats) for _ in range(size)]
        dist.all_gather(parts, feats.contiguous(), group=group)
        ctx.meta = (n_banks, rank, size, w)
        return (torch.stack(parts, dim=1).view(B, size, n_banks, w).permute(0, 2, 1, 3)
                .reshape(B, n_banks * size * w))

    @staticmethod
    def backward(ctx, g):
        n_banks, rank, size, w = ctx.meta
        B = g.shape[0]
        mine = g.reshape(B, n_banks, size, w)[:, :, rank].reshape(B, n_banks * w)
        return mine, None, None, None, None


def gather_cp_features(mesh, feats: torch.Tensor, n_banks: int) -> torch.Tensor:
    """All-gather the CP feature columns of the model ranks (see
    ``_GatherFeatures``); ``feats`` [B, n_banks * R / M] from the rank's
    bank shards. Every model rank of the data group must call it."""
    return _GatherFeatures.apply(feats, n_banks, mesh.get_group(MODEL_AXIS),
                                 axis_rank(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS))


@torch.no_grad()
def sync_gradients(params: Iterable[torch.nn.Parameter], mesh) -> None:
    """Replace each gradient by its mean over the data ranks: the
    gradients of one dtype go into one flat buffer, one ``all_reduce`` over
    ``data``, divided by its size. A replicated parameter's gradient is
    the same on every model rank of a data group; a bank shard's is
    averaged within its own model column. Parameters without a gradient
    (the same on every rank) are left out."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    D = axis_size(mesh, DATA_AXIS)
    group = mesh.get_group(DATA_AXIS)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(D)
        o = 0
        for g in grads:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()


def rank_budget(mesh, n_valid: torch.Tensor, budget: int) -> int:
    """This data rank's share of a batch-wide budget of compact samples.
    The turbo march drops the whole batch's ray-major tail past the
    budget; data rank d holds the d-th slice of the rays, so its samples
    start after p, the valid slots of the ranks before it, and it may fill
    ``max(budget - p, 0)``. ``n_valid``: this rank's count (a scalar
    tensor). One small all-gather and a host read."""
    counts = gather_predictions_dp(mesh, n_valid.reshape(1).to(torch.int64))
    p = int(counts[:axis_rank(mesh, DATA_AXIS)].sum())
    return max(int(budget) - p, 0)

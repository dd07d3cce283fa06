"""Loss functions (``ngp_tpu/ops/losses.py``): MAPE, Huber and the O(N)
effective distortion loss. Plain tensor functions in f32, as the JAX
functions cast; autograd differentiates ``eff_distloss`` as JAX's
autodiff does (no hand-written backward)."""

from __future__ import annotations

import torch


def mape_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Mean absolute percentage error, |pred - target| / (|target| + 1e-2)."""
    difference = (pred - target).float()
    scale = 1.0 / (target.float().abs() + 1e-2)
    loss = difference.abs() * scale
    return loss.mean() if reduction == "mean" else loss


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1,
               reduction: str = "mean") -> torch.Tensor:
    """Huber in its smooth-L1 form: 0.5 / delta * err^2 for |err| <= delta,
    |err| - 0.5 * delta beyond."""
    abs_err = (pred.float() - target.float()).abs()
    loss = torch.where(abs_err > delta, abs_err - 0.5 * delta, 0.5 / delta * abs_err**2)
    return loss.mean() if reduction == "mean" else loss


def eff_distloss(ws: torch.Tensor, ts: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Distortion loss over per-ray samples [..., N] sorted by t:

        L = sum_{i,j} w_i w_j |t_i - t_j| + (1/3) sum_i w_i^2 delta_i,

    in O(N) with exclusive prefix sums, averaged over the rays."""
    ws, ts, deltas = ws.float(), ts.float(), deltas.float()
    cum_w = torch.cumsum(ws, dim=-1) - ws
    cum_wt = torch.cumsum(ws * ts, dim=-1) - ws * ts
    cross = 2.0 * (ws * (ts * cum_w - cum_wt)).sum(dim=-1)
    self_term = (ws**2 * deltas).sum(dim=-1) / 3.0
    return (cross + self_term).mean()

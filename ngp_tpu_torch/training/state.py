"""Optimizer, learning-rate schedule and EMA (``ngp_tpu/training/state.py``
and ``ngp_tpu/training/trainer.py:86-102``).

- Adam with b1 0.9, b2 0.99 and eps 1e-15 (optax.adam's update);
- a learning rate of lr * target ** min(step / max_steps, 1), equal to
  optax's ``exponential_decay`` with ``end_value = lr * target``,
  stepped once per train step;
- named groups of parameters, each with its own rate and decay: the
  counterpart of ``optax.multi_transform`` over one Adam per group
  (``ngp_tpu/training/tensorf.py:80-108``);
- an EMA shadow of every parameter, shadow = decay * shadow +
  (1 - decay) * param after every optimizer step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn


def make_optimizer(groups: Sequence[Tuple[str, List[nn.Parameter], float, float]],
                   max_steps: int) -> Tuple[torch.optim.Adam,
                                            torch.optim.lr_scheduler.LambdaLR]:
    """Adam over ``groups`` of (name, parameters, learning rate, decay
    target); each group's rate decays to its target share of itself over
    ``max_steps``. An empty group is left out."""
    groups = [g for g in groups if g[1]]
    opt = torch.optim.Adam([{"params": ps, "lr": lr, "name": name}
                            for name, ps, lr, _ in groups],
                           betas=(0.9, 0.99), eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, [lambda step, t=target: t ** min(step / max_steps, 1.0)
              for *_, target in groups])
    return opt, sched


class EMA:
    """Per-step exponential moving average of a module's parameters."""

    def __init__(self, model: nn.Module, decay: float):
        self.decay = decay
        self.params = dict(model.named_parameters())
        self.shadow = {k: p.detach().clone() for k, p in self.params.items()}

    @torch.no_grad()
    def update(self) -> None:
        shadow = list(self.shadow.values())
        torch._foreach_mul_(shadow, self.decay)
        torch._foreach_add_(shadow, [p.detach() for p in self.params.values()],
                            alpha=1.0 - self.decay)

    @contextlib.contextmanager
    def average_parameters(self):
        """Swap the shadow into the module's parameters for the body of
        the ``with`` block, and the live values back after it."""
        live = {k: p.detach().clone() for k, p in self.params.items()}
        try:
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(self.shadow[k])
            yield
        finally:
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(live[k])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.shadow)

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> List[str]:
        """Take each saved shadow whose name and shape match; returns the
        names of the others, which keep their fresh values."""
        skipped = []
        with torch.no_grad():
            for k, v in self.shadow.items():
                if k in sd and tuple(sd[k].shape) == tuple(v.shape):
                    v.copy_(sd[k])
                else:
                    skipped.append(k)
        return skipped

"""Optimizer, learning-rate schedule and EMA (``ngp_tpu/training/state.py``
and ``ngp_tpu/training/trainer.py:86-102``).

- Adam with b1 0.9, b2 0.99 and eps 1e-15 (optax.adam's update);
- a learning rate of lr * target ** min(step / max_steps, 1), equal to
  optax's ``exponential_decay`` with ``end_value = lr * target``,
  stepped once per train step;
- an EMA shadow of every parameter, shadow = decay * shadow +
  (1 - decay) * param after every optimizer step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def make_optimizer(params: Iterable[nn.Parameter], lr: float, max_steps: int,
                   decay_target: float = 0.1) -> Tuple[torch.optim.Adam,
                                                       torch.optim.lr_scheduler.LambdaLR]:
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: decay_target ** min(step / max_steps, 1.0)
    )
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

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, v in self.shadow.items():
                v.copy_(sd[k])

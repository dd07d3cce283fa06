"""Image losses for the random-pose guidance steps
(``ngp_tpu/training/clip_guidance.py``; the reference's
``nerf/clip_utils.py``).

``GradientImageLoss`` is the weight-free stand-in with the CLIP loss's
interface: images [B, H, W, 3] in [0, 1] -> a scalar, differentiable by
autograd. ``CLIPLoss`` (CLIP towers scoring renders against a text
prompt) is not ported yet.
"""

from __future__ import annotations

import torch


class CLIPLoss:
    def __init__(self, text: str, model_path=None, **kwargs):
        raise NotImplementedError(
            "CLIP guidance (--clip_model_path) is not ported yet (ROADMAP §1 item 9); "
            "without --clip_model_path the guidance steps use GradientImageLoss")


class GradientImageLoss:
    """Encourages smooth, colourful renders: the mean absolute difference
    of neighbouring pixels (down and across) less the mean saturation."""

    def __init__(self, text: str = ""):
        self.text = text

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        sat = images.amax(dim=-1) - images.amin(dim=-1)
        tv = (torch.diff(images, dim=1).abs().mean()
              + torch.diff(images, dim=2).abs().mean())
        return tv - sat.mean()

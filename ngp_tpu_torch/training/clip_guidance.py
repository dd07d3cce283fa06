"""Image losses for the random-pose guidance steps
(``ngp_tpu/training/clip_guidance.py``; the reference's
``nerf/clip_utils.py``).

Both take images [B, H, W, 3] in [0, 1] to a scalar, differentiable by
autograd back to the render. ``CLIPLoss`` scores the renders against a
text prompt with the CLIP towers (``models/clip.py``): minus the mean
cosine similarity of the image embeddings and the prompt's.
``GradientImageLoss`` is the weight-free stand-in with the same
interface.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


class CLIPLoss:
    """Differentiable CLIP guidance (the reference's utils.py:473-488).

    Construction options, as the JAX class takes them:
    - ``model_path``: a local HF 'openai/clip-vit-base-patch16' checkout
      (weights and tokenizer parsed once on the host; needs
      ``transformers``);
    - ``clip_cfg`` / ``params`` / ``token_ids``: a ``CLIPConfig``, the
      port's CLIP state dict (``models.clip.params_from_jax`` converts the
      flax params) and the tokenized prompt [1, T].
    The towers are built on ``device`` (the card unless the caller asks
    for another) and frozen; the prompt's embedding is computed once,
    normalised and detached."""

    def __init__(self, text: str, model_path: Optional[str] = None, clip_cfg=None,
                 params: Optional[Mapping] = None, token_ids=None, device="cuda"):
        from ngp_tpu_torch.models.clip import CLIP, load_hf_clip

        if model_path is not None:
            clip_cfg, params = load_hf_clip(model_path)
            from transformers import CLIPTokenizer

            tok = CLIPTokenizer.from_pretrained(model_path)
            token_ids = np.asarray(
                tok([text], padding="max_length", max_length=clip_cfg.context_length,
                    truncation=True)["input_ids"], np.int64)
        if clip_cfg is None or params is None or token_ids is None:
            raise RuntimeError(
                "CLIP guidance needs pretrained weights; pass model_path= to "
                "a local 'openai/clip-vit-base-patch16' checkout, or supply "
                "clip_cfg/params/token_ids directly (nothing is downloaded)."
            )
        self.cfg = clip_cfg
        self.model = CLIP(clip_cfg, device=device)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        self.model.requires_grad_(False).eval()
        with torch.no_grad():
            te = self.model.encode_text(torch.as_tensor(np.asarray(token_ids), device=device))
        self.text_features = te / te.norm(dim=-1, keepdim=True)  # [1, E]

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] in [0, 1] -> scalar loss (clip_utils.py:50-63)."""
        from ngp_tpu_torch.models.clip import preprocess

        emb = self.model.encode_image(preprocess(images, self.cfg))
        emb = emb / emb.norm(dim=-1, keepdim=True)
        return -(emb @ self.text_features.T).mean()


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

"""CLIP, the vision and text towers, in PyTorch (``ngp_tpu/models/clip.py``).

The architecture of HuggingFace's ``CLIPModel`` and of the JAX package's
flax copy: pre-LN transformer blocks with quick-GELU MLPs, a ViT vision
tower (a bias-free patch convolution, the class token, learned
positions, ``pre_layrnorm`` / ``post_layernorm``), a causal text tower
pooled at the end-of-text token (the largest id), and bias-free
projections to the joint embedding. Differentiable in the pixels, which
is what CLIP guidance trains through (``training/clip_guidance.py``).
Attention and the products are plain torch (``torch.matmul``, softmax),
as JAX leaves them to XLA.

Weights: drawn from a seeded CPU ``torch.Generator`` (fan-in scaled
normals, as flax's dense default), converted from the flax params
(``params_from_jax``), or read from a local HuggingFace checkout
(``load_hf_clip``, which needs ``transformers``); the state dict's keys
follow the flax names (``vision.layers.<i>.self_attn.q_proj.weight``, ...).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# CLIP pixel normalization (openai/clip-vit-base-patch16 processor)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Widths of the two towers; the defaults are ViT-B/16's."""

    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        """Architecture-faithful miniature for tests."""
        return cls(
            image_size=32, patch_size=8, vision_width=32, vision_layers=2,
            vision_heads=2, text_width=32, text_layers=2, text_heads=2,
            vocab_size=64, context_length=16, embed_dim=16,
        )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _linear(d_in: int, d_out: int, g: torch.Generator, device, bias: bool = True) -> nn.Linear:
    """nn.Linear with N(0, 1/d_in) weights (flax's dense default) and zero bias."""
    layer = nn.Linear(d_in, d_out, bias=bias, device=device)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((d_out, d_in), generator=g) * d_in**-0.5)
        if bias:
            layer.bias.zero_()
    return layer


def _param(shape, g: torch.Generator, device, std: float = 0.02) -> nn.Parameter:
    return nn.Parameter((torch.randn(shape, generator=g) * std).to(device))


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int, g: torch.Generator, device):
        super().__init__()
        self.width, self.heads = width, heads
        self.q_proj = _linear(width, width, g, device)
        self.k_proj = _linear(width, width, g, device)
        self.v_proj = _linear(width, width, g, device)
        self.out_proj = _linear(width, width, g, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        hd = self.width // self.heads

        def heads(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            att = att + mask
        att = torch.softmax(att, dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, T, self.width)
        return self.out_proj(out)


class _Block(nn.Module):
    def __init__(self, width: int, heads: int, g: torch.Generator, device):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.self_attn = _Attention(width, heads, g, device)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.fc1 = _linear(width, 4 * width, g, device)
        self.fc2 = _linear(4 * width, width, g, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, g: torch.Generator, device):
        super().__init__()
        c = self.cfg = cfg
        w, p = c.vision_width, c.patch_size
        self.patch_embedding = nn.Conv2d(3, w, p, stride=p, bias=False, device=device)
        with torch.no_grad():
            self.patch_embedding.weight.copy_(
                torch.randn((w, 3, p, p), generator=g) * (3 * p * p) ** -0.5)
        self.class_embedding = _param((w,), g, device)
        self.position_embedding = _param(((c.image_size // p) ** 2 + 1, w), g, device)
        self.pre_layrnorm = nn.LayerNorm(w, eps=1e-5, device=device)  # (sic: HF's key name)
        self.layers = nn.ModuleList(_Block(w, c.vision_heads, g, device)
                                    for _ in range(c.vision_layers))
        self.post_layernorm = nn.LayerNorm(w, eps=1e-5, device=device)
        self.visual_projection = _linear(w, c.embed_dim, g, device, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: [B, S, S, 3] normalized -> [B, embed_dim]."""
        B = pixels.shape[0]
        h = self.patch_embedding(pixels.permute(0, 3, 1, 2))  # NCHW
        h = h.flatten(2).transpose(1, 2)  # [B, patches, w], row-major patches
        h = torch.cat([self.class_embedding.expand(B, 1, -1), h], dim=1)
        h = self.pre_layrnorm(h + self.position_embedding[None])
        for layer in self.layers:
            h = layer(h)
        return self.visual_projection(self.post_layernorm(h[:, 0]))


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, g: torch.Generator, device):
        super().__init__()
        c = self.cfg = cfg
        w = c.text_width
        self.token_embedding = nn.Embedding(c.vocab_size, w, device=device)
        with torch.no_grad():
            self.token_embedding.weight.copy_(torch.randn((c.vocab_size, w), generator=g) * 0.02)
        self.position_embedding = _param((c.context_length, w), g, device)
        self.layers = nn.ModuleList(_Block(w, c.text_heads, g, device)
                                    for _ in range(c.text_layers))
        self.final_layer_norm = nn.LayerNorm(w, eps=1e-5, device=device)
        self.text_projection = _linear(w, c.embed_dim, g, device, bias=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids: [B, T] token ids -> [B, embed_dim], pooled at the end-of-text
        token, which has the largest id in CLIP's vocabulary."""
        ids = ids.long()
        T = ids.shape[1]
        h = self.token_embedding(ids) + self.position_embedding[None, :T]
        mask = torch.full((T, T), -math.inf, device=h.device).triu(1)[None, None]
        for layer in self.layers:
            h = layer(h, mask)
        h = self.final_layer_norm(h)
        pooled = h[torch.arange(h.shape[0], device=h.device), ids.argmax(dim=-1)]
        return self.text_projection(pooled)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.vision = VisionTower(cfg, g, device)
        self.text = TextTower(cfg, g, device)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision(pixels)

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text(ids)

    def forward(self, pixels: torch.Tensor, ids: torch.Tensor):
        return self.encode_image(pixels), self.encode_text(ids)


def preprocess(images: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized to image_size^2 and normalized,
    differentiable. Bilinear with half-pixel centres, antialiased when it
    shrinks (a triangle filter widened by the scale), as
    ``jax.image.resize(..., "bilinear")`` resizes."""
    S = cfg.image_size
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(S, S), mode="bilinear",
                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
    mean = torch.as_tensor(IMAGE_MEAN, device=images.device)
    std = torch.as_tensor(IMAGE_STD, device=images.device)
    return (x - mean) / std


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Flax ``CLIP`` params (nested dicts of arrays, with or without the
    top-level ``"params"`` key) -> the port's state dict: dense kernels
    [in, out] -> weights [out, in], the patch convolution's HWIO kernel
    -> OIHW, LayerNorm scales and embedding tables -> ``weight``,
    ``layers_<i>`` -> ``layers.<i>``."""
    out = {}

    def walk(node, path):
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [re.sub(r"^layers_(\d+)$", r"layers.\1", name)])
                continue
            a = np.array(v, np.float32)
            if name == "kernel":
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            key = "weight" if name in ("kernel", "scale", "embedding") else name
            out[".".join(path + [key])] = torch.from_numpy(np.ascontiguousarray(a))

    walk(tree.get("params", tree), [])
    return out


def _hf_key(key: str) -> Optional[str]:
    """A HuggingFace ``CLIPModel`` state-dict key -> the port's, or None
    for a key the towers do not use (``logit_scale``, position ids)."""
    rules = (
        (r"^vision_model\.embeddings\.patch_embedding\.", "vision.patch_embedding."),
        (r"^vision_model\.embeddings\.class_embedding$", "vision.class_embedding"),
        (r"^vision_model\.embeddings\.position_embedding\.weight$",
         "vision.position_embedding"),
        (r"^vision_model\.(pre_layrnorm|post_layernorm)\.", r"vision.\1."),
        (r"^vision_model\.encoder\.layers\.(\d+)\.(mlp\.)?", r"vision.layers.\1."),
        (r"^visual_projection\.", "vision.visual_projection."),
        (r"^text_model\.embeddings\.token_embedding\.", "text.token_embedding."),
        (r"^text_model\.embeddings\.position_embedding\.weight$", "text.position_embedding"),
        (r"^text_model\.final_layer_norm\.", "text.final_layer_norm."),
        (r"^text_model\.encoder\.layers\.(\d+)\.(mlp\.)?", r"text.layers.\1."),
        (r"^text_projection\.", "text.text_projection."),
    )
    for pat, rep in rules:
        if re.search(pat, key):
            return re.sub(pat, rep, key)
    return None


def load_hf_clip(model_path: str) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """A local HuggingFace CLIP checkout -> (config, the port's state dict
    on the CPU). ``transformers`` parses the checkpoint; nothing is
    fetched."""
    try:
        from transformers import CLIPModel
    except ImportError as e:
        raise ImportError("load_hf_clip reads a HuggingFace CLIP checkout through "
                          "transformers, which is not installed") from e

    m = CLIPModel.from_pretrained(model_path)
    hc = m.config
    cfg = CLIPConfig(
        image_size=hc.vision_config.image_size,
        patch_size=hc.vision_config.patch_size,
        vision_width=hc.vision_config.hidden_size,
        vision_layers=hc.vision_config.num_hidden_layers,
        vision_heads=hc.vision_config.num_attention_heads,
        text_width=hc.text_config.hidden_size,
        text_layers=hc.text_config.num_hidden_layers,
        text_heads=hc.text_config.num_attention_heads,
        vocab_size=hc.text_config.vocab_size,
        context_length=hc.text_config.max_position_embeddings,
        embed_dim=hc.projection_dim,
    )
    sd = {}
    for k, v in m.state_dict().items():
        key = _hf_key(k)
        if key is not None:
            sd[key] = v.detach().float().clone()
    return cfg, sd

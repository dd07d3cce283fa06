"""LPIPS perceptual distance, AlexNet backbone (``ngp_tpu/training/lpips.py``).

The reference meter's ``lpips.LPIPS(net='alex')`` (Zhang et al. 2018):
AlexNet conv features at the five ReLU taps, each unit-normalised over
its channels, the squared difference weighted by a learned 1x1 head,
the spatial mean, summed over the taps.

The parameters are a dict of arrays in the JAX module's names and
layout (``conv<i>_w`` [k, k, in, out], ``conv<i>_b`` [out], ``lin<i>_w``
[out]), so one set of weights serves both packages; ``lpips`` turns the
kernels to PyTorch's [out, in, k, k] for ``conv2d``. Pretrained weights
are not fetched: ``load_torch_weights`` converts a local checkpoint, and
``random_params`` draws the architecture's shapes for tests and smoke
runs. The convolutions run in full f32: cuDNN would run them in TF32 by
default on a card (``torch.backends.cudnn.allow_tf32``), where JAX asks
for ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as tnf

# AlexNet feature stack (torchvision order): (out channels, kernel, stride,
# padding, max pool before the conv); each tap is a ReLU output
_ALEX = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)

# LPIPS input scaling (x in [-1, 1]): (x - shift) / scale
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_params(generator: Optional[torch.Generator] = None,
                  in_ch: int = 3) -> Dict[str, np.ndarray]:
    """Weights of the right shapes (tests, smoke runs): conv kernels
    N(0, 1 / fan_in), zero biases, heads U(0, 1), drawn from a CPU
    generator."""
    g = generator or torch.Generator().manual_seed(0)
    params = {}
    c_in = in_ch
    for i, (c_out, k, _, _, _) in enumerate(_ALEX):
        w = torch.randn((k, k, c_in, c_out), generator=g) / np.sqrt(k * k * c_in)
        params[f"conv{i}_w"] = w.numpy().astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((c_out,), np.float32)
        params[f"lin{i}_w"] = torch.rand((c_out,), generator=g).numpy().astype(np.float32)
        c_in = c_out
    return params


def load_torch_weights(path: str) -> Dict[str, np.ndarray]:
    """A local checkpoint -> LPIPS params. Takes the ``lpips`` package's
    state dict (``net.slice<1-5>.<i>.*`` and ``lin<0-4>.model.1.weight``)
    or a dict of torchvision AlexNet ``features.*`` (or
    ``alexnet.features.*``) and ``lins.<i>.weight`` entries."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
          for k, v in sd.items() if torch.is_tensor(v) or isinstance(v, np.ndarray)}

    def grab(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(f"none of {names} in checkpoint ({list(sd)[:8]}...)")

    # torchvision's feature indices of the convs, and the lpips package's slices
    tv_idx = (0, 3, 6, 8, 10)
    slices = ("net.slice1.0", "net.slice2.3", "net.slice3.6", "net.slice4.8", "net.slice5.10")
    params = {}
    for i in range(len(_ALEX)):
        w = grab(f"features.{tv_idx[i]}.weight", f"alexnet.features.{tv_idx[i]}.weight",
                 f"{slices[i]}.weight")
        b = grab(f"features.{tv_idx[i]}.bias", f"alexnet.features.{tv_idx[i]}.bias",
                 f"{slices[i]}.bias")
        params[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)  # OIHW -> HWIO
        params[f"conv{i}_b"] = b.astype(np.float32)
        lw = grab(f"lin{i}.model.1.weight", f"lins.{i}.weight")
        params[f"lin{i}_w"] = lw.reshape(-1).astype(np.float32)
    return params


def _features(params, x: torch.Tensor):
    """x [B, 3, H, W] in [-1, 1] -> the 5 tap activations, NCHW."""
    f32 = dict(dtype=torch.float32, device=x.device)
    shift = torch.as_tensor(_SHIFT, **f32)[:, None, None]
    h = (x - shift) / torch.as_tensor(_SCALE, **f32)[:, None, None]
    taps = []
    for i, (_, _, stride, pad, pool) in enumerate(_ALEX):
        if pool:
            h = tnf.max_pool2d(h, 3, stride=2)
        w = torch.as_tensor(params[f"conv{i}_w"], **f32).permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = torch.relu(tnf.conv2d(h, w, torch.as_tensor(params[f"conv{i}_b"], **f32),
                                  stride=stride, padding=pad))
        taps.append(h)
    return taps


def lpips(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Perceptual distance [B] between image batches [B, H, W, 3] in
    [0, 1], on their device; differentiable. AlexNet's strides and pools
    need frames of at least 31 x 31 pixels."""
    if min(x.shape[1], x.shape[2]) < 31:
        raise ValueError(f"lpips: AlexNet needs frames of at least 31 x 31 pixels, got "
                         f"{x.shape[1]} x {x.shape[2]}")
    x = (2.0 * x.float() - 1.0).permute(0, 3, 1, 2)
    y = (2.0 * y.float() - 1.0).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic,
                                    allow_tf32=False):
        fx, fy = _features(params, x), _features(params, y)
    total = torch.zeros(x.shape[0], device=x.device)
    for i, (a, b) in enumerate(zip(fx, fy)):
        a = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        w = torch.as_tensor(params[f"lin{i}_w"], dtype=torch.float32, device=x.device)
        total = total + (((a - b) ** 2) * w[:, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total

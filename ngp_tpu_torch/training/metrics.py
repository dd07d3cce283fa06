"""Image quality meters: PSNR and SSIM (``ngp_tpu/training/metrics.py``).

The clear/update/measure/write/report protocol of the JAX meters
(reference nerf/utils.py:206-314). SSIM is the Gaussian-windowed
variant of torchmetrics' defaults: 11x11 window, sigma 1.5, k1 0.01,
k2 0.03, 'valid' filtering, the window shrinking below 11 px.

Both are computed on the CPU in f32, whatever device the images come
from: the frames they score are already on the host, and on a card
cuDNN would run the f32 convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32``), whose ~1e-3 relative error
swamps SSIM's variance terms on mostly white frames (the JAX module
records SSIM reading 1.05-2.5 when its convolution lost precision).

LPIPS needs pretrained perceptual-network weights and is not ported:
``LPIPSMeter`` raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf


def _host(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def psnr(pred, target) -> torch.Tensor:
    mse = torch.mean((_host(pred) - _host(target)) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, target, data_range: float = 1.0) -> torch.Tensor:
    """SSIM over [H, W, C] images (mean over channels and positions)."""
    pred, target = _host(pred), _host(target)
    size = min(11, pred.shape[0], pred.shape[1])
    if size % 2 == 0:
        size -= 1
    k = _gaussian_kernel(size)[None, None]  # [1, 1, size, size]

    def filt(img):
        # [H, W, C] -> depthwise Gaussian blur, 'valid' padding, [H', W', C]
        return tnf.conv2d(img.permute(2, 0, 1)[:, None], k)[:, 0].permute(1, 2, 0)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p = filt(pred)
    mu_t = filt(target)
    mu_pp = filt(pred * pred) - mu_p**2
    mu_tt = filt(target * target) - mu_t**2
    mu_pt = filt(pred * target) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (mu_pp + mu_tt + c2)
    return torch.mean(num / den)


class _MeterBase:
    def __init__(self):
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step, prefix=""):
        if writer is not None:
            writer.add_scalar(f"{prefix}/{self.name()}", self.measure(), global_step)


class PSNRMeter(_MeterBase):
    def name(self):
        return "PSNR"

    def update(self, preds, truths):
        self.V += float(psnr(preds, truths))
        self.N += 1

    def report(self):
        return f"PSNR = {self.measure():.6f}"


class SSIMMeter(_MeterBase):
    def name(self):
        return "SSIM"

    def update(self, preds, truths):
        p, t = _host(preds), _host(truths)
        if p.ndim == 4:  # [B, H, W, C]
            for i in range(p.shape[0]):
                self.V += float(ssim(p[i], t[i]))
                self.N += 1
        else:
            self.V += float(ssim(p, t))
            self.N += 1

    def report(self):
        return f"SSIM = {self.measure():.6f}"


class LPIPSMeter(_MeterBase):
    """Not ported: LPIPS needs local AlexNet-LPIPS weights and a port of
    ``ngp_tpu/training/lpips.py``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LPIPS is not ported to ngp_tpu_torch yet (it needs local AlexNet-LPIPS "
            "weights and a port of ngp_tpu/training/lpips.py); evaluate without it"
        )

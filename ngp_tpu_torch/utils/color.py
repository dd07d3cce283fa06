"""Color-space conversions (``ngp_tpu/utils/color.py``; reference
nerf/utils.py:44-51): linear images for training from sRGB files, and
back to sRGB at export."""

from __future__ import annotations

import numpy as np


def linear_to_srgb_np(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x < 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)


def srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)

"""Image-quality metrics for the denoising suite (paper §5.2, Figs 7-8).

PSNR, and SSIM with an 11x11 Gaussian window (sigma 1.5, Wang et al. 2004)
computed per channel over VALID positions and averaged — the JAX package's
formulations. Inputs are (H, W), (H, W, C) or (B, H, W, C); every leading
element is part of one mean.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.nn.conv import no_tf32


def _as_nhwc(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:
        return x[None, :, :, None]
    if x.ndim == 3:
        return x[None]
    if x.ndim == 4:
        return x
    raise ValueError(f"expected (H,W), (H,W,C) or (B,H,W,C); got "
                     f"{tuple(x.shape)}")


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (mse floored at 1e-12)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    mse = torch.mean((a - b) ** 2)
    return (20.0 * float(np.log10(max_val))
            - 10.0 * torch.log10(torch.clamp_min(mse, 1e-12)))


@lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID correlation of (B,H,W,C) with a (k,k) window, in
    float32 with TF32 off."""
    c = x.shape[-1]
    weight = kern[None, None].expand(c, 1, *kern.shape).contiguous()
    with no_tf32():
        y = Fn.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, *, max_val: float = 1.0,
         win_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity with a Gaussian window (Wang et al. 2004).

    The window shrinks (to the next odd size) on images smaller than
    ``win_size``."""
    a4 = _as_nhwc(a.to(torch.float32))
    b4 = _as_nhwc(b.to(torch.float32))
    if a4.shape != b4.shape:
        raise ValueError(f"shape mismatch: {tuple(a4.shape)} vs "
                         f"{tuple(b4.shape)}")
    win = min(win_size, a4.shape[1], a4.shape[2])
    if win % 2 == 0:
        win -= 1
    kern = torch.as_tensor(_gaussian_window(win, sigma), device=a4.device)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _filter(a4, kern)
    mu_b = _filter(b4, kern)
    var_a = _filter(a4 * a4, kern) - mu_a ** 2
    var_b = _filter(b4 * b4, kern) - mu_b ** 2
    cov = _filter(a4 * b4, kern) - mu_a * mu_b
    ssim_map = (((2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2))
                / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return torch.mean(ssim_map)

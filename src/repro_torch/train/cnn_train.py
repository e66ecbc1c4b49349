"""Evaluation loops for the paper's application models (classification on
synthetic digits, denoising on synthetic textures), with the JAX package's
defaults. Training (``fit``, AdamW, the STE backward) is a later slice of
the port; weights come from ``init_params`` or from the JAX package through
``repro_torch.convert.params_from_jax``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.data import synthetic
from repro_torch.eval import image as IQ
from repro_torch.models import cnn as CNN
from repro_torch.nn.module import resolve_device
from repro_torch.quant.quantize import QuantConfig


@torch.inference_mode()
def classifier_logits(params, apply_fn: Callable, quant: QuantConfig, *,
                      n_test=500, seed=1, batch=50,
                      device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (n_test, classes), labels (n_test,)) on ``device``."""
    dev = resolve_device(device)
    imgs, labels = synthetic.digits(n_test, seed=seed)
    x = torch.from_numpy(imgs).to(dev)
    logits = [apply_fn(params, x[i:i + batch], quant)
              for i in range(0, n_test, batch)]
    return torch.cat(logits), torch.from_numpy(labels).to(dev)


def eval_classifier(params, apply_fn: Callable, quant: QuantConfig, *,
                    n_test=500, seed=1, batch=50, device="cuda") -> float:
    """Top-1 accuracy in percent on ``n_test`` synthetic digits."""
    logits, labels = classifier_logits(params, apply_fn, quant,
                                       n_test=n_test, seed=seed,
                                       batch=batch, device=device)
    correct = int((torch.argmax(logits, -1) == labels).sum())
    return 100.0 * correct / n_test


@torch.inference_mode()
def denoise(params, cfg: CNN.FFDNetConfig, quant: QuantConfig, *,
            sigma=25.0, n=16, size=64, seed=3, device="cuda"):
    """(clean, noisy, denoised) on ``device``; denoised is clipped to
    [0, 1]."""
    dev = resolve_device(device)
    clean = synthetic.textures(n, size=size, seed=seed)
    noisy = synthetic.add_noise(clean, sigma, seed=seed + 1)
    clean_t = torch.from_numpy(clean).to(dev)
    noisy_t = torch.from_numpy(noisy).to(dev)
    out = CNN.ffdnet_apply(params, noisy_t, sigma / 255.0, cfg, quant)
    return clean_t, noisy_t, torch.clamp(out, 0, 1)


def eval_denoiser(params, cfg: CNN.FFDNetConfig, quant: QuantConfig, *,
                  sigma=25.0, n=16, size=64, seed=3, device="cuda"):
    """(denoised PSNR dB, Gaussian-window SSIM, noisy PSNR dB)."""
    clean, noisy, out = denoise(params, cfg, quant, sigma=sigma, n=n,
                                size=size, seed=seed, device=device)
    return (float(IQ.psnr(out, clean)), float(IQ.ssim(out, clean)),
            float(IQ.psnr(noisy, clean)))

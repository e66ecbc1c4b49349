"""Reusable fit/eval loops for the paper's application models
(classification on synthetic digits, denoising on synthetic textures),
with the JAX package's recipes and defaults.

``fit`` is the one training loop: init params + AdamW, one ``train_step``
per batch of the stream. ``train_classifier`` / ``train_denoiser`` only
differ in their loss and batch stream (the JAX package's, drawn from
``np.random.default_rng(seed)``); the eval helpers are what
``repro_torch.eval.runners`` sweeps across backends. Training runs with
autograd on; the eval helpers run under ``torch.inference_mode``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.data import synthetic
from repro_torch.eval import image as IQ
from repro_torch.models import cnn as CNN
from repro_torch.nn.module import init_params, resolve_device
from repro_torch.optim import adamw
from repro_torch.quant.quantize import BF16, QuantConfig


@contextlib.contextmanager
def training_numerics():
    """Full float32 in every matmul and cuDNN convolution of a training
    step, the backward included (the backward runs after ``nn.conv``'s own
    TF32 guard has been left), and cuDNN's deterministic algorithms (its
    fastest weight-gradient algorithms sum with atomics, in an order that
    changes from run to run). The flags are restored on exit. No bf16
    matmul is on the training path."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved


def value_and_grad(loss_fn: Callable, params, *batch):
    """(loss, grads): ``jax.value_and_grad(loss_fn)(params, *batch)`` for a
    nested dict of tensors; grads has params' keys."""
    pairs = adamw.flatten(params)
    leaves = [p.detach().requires_grad_(True) for _, p in pairs]
    loss = loss_fn(adamw.unflatten(
        (path, t) for (path, _), t in zip(pairs, leaves)), *batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), adamw.unflatten(
        (path, g) for (path, _), g in zip(pairs, grads))


def train_step(params, opt_state, batch: Tuple, loss_fn: Callable,
               ocfg: adamw.AdamWConfig):
    """One step of ``fit``: loss and gradients, then one AdamW update, under
    ``training_numerics`` (cuDNN deterministic). Returns (params,
    opt_state, loss)."""
    with training_numerics():
        loss, grads = value_and_grad(loss_fn, params, *batch)
        params, opt_state = adamw.update(grads, opt_state, params, ocfg)
    return params, opt_state, loss


def fit(descs, loss_fn: Callable, batches: Iterable[Tuple], *, steps: int,
        lr: float, seed: int = 0, weight_decay: float = 0.0,
        device="cuda"):
    """Generic supervised loop: returns (params, per-step losses).

    loss_fn(params, *batch) -> scalar; `batches` yields the batch tuples
    (numpy arrays, moved to ``device`` per step). Params are drawn by
    ``init_params`` from a ``torch.Generator`` seeded with ``seed``.
    """
    dev = resolve_device(device)
    params = init_params(descs, torch.Generator().manual_seed(seed), dev)
    ocfg = adamw.AdamWConfig(lr=lr, weight_decay=weight_decay)
    opt = adamw.init(params, ocfg)
    losses: List[torch.Tensor] = []
    for _, batch in zip(range(steps), batches):
        batch = tuple(torch.as_tensor(b, device=dev) for b in batch)
        params, opt, loss = train_step(params, opt, batch, loss_fn, ocfg)
        losses.append(loss)
    return params, [float(loss) for loss in losses]


# ---------------------------------------------------------------------------
# classification (paper §5.1, Table 5)
# ---------------------------------------------------------------------------

def classifier_loss(apply_fn: Callable, quant: QuantConfig = BF16,
                    qat: bool = False) -> Callable:
    """Mean cross-entropy of ``apply_fn``'s logits: loss_fn(p, x, y)."""
    def loss_fn(p, x, y):
        logits = apply_fn(p, x, quant, qat)
        one = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return -one.gather(1, y.long()[:, None]).mean()
    return loss_fn


def classifier_batches(imgs: np.ndarray, labels: np.ndarray, *, batch: int,
                       seed: int):
    """The JAX package's classification stream: random draws, with
    replacement, from the training digits."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, imgs.shape[0], batch)
        yield imgs[idx], labels[idx]


def train_classifier(descs, apply_fn, *, steps=300, batch=64, lr=2e-3,
                     n_train=5000, seed=0, qat=False,
                     quant: QuantConfig = BF16, device="cuda"):
    """Train on synthetic digits (paper §5.1 uses 5000 train / 500 test)."""
    imgs, labels = synthetic.digits(n_train, seed=seed)
    params, _ = fit(descs, classifier_loss(apply_fn, quant, qat),
                    classifier_batches(imgs, labels, batch=batch, seed=seed),
                    steps=steps, lr=lr, seed=seed, device=device)
    return params


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


# ---------------------------------------------------------------------------
# denoising (paper §5.2, Figs 7-8)
# ---------------------------------------------------------------------------

def denoiser_loss(cfg: CNN.FFDNetConfig, quant: QuantConfig = BF16,
                  qat: bool = False) -> Callable:
    """Mean squared error of the denoised output: loss_fn(p, noisy,
    target, sigma), sigma of shape (B,) in units of 1/255."""
    def loss_fn(p, noisy, target, sg):
        out = CNN.ffdnet_apply(p, noisy, sg, cfg, quant, qat)
        return torch.mean((out - target) ** 2)
    return loss_fn


def denoiser_batches(clean: np.ndarray, *, batch: int, sigmas, seed: int):
    """The JAX package's denoising stream: random clean textures, a noise
    level per image drawn from ``sigmas``, Gaussian noise."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, clean.shape[0], batch)
        sig = rng.choice(sigmas, batch).astype(np.float32)
        tgt = clean[idx]
        noisy = tgt + (sig[:, None, None, None] / 255.0) * \
            rng.standard_normal(tgt.shape).astype(np.float32)
        yield noisy, tgt, sig / 255.0


def train_denoiser(cfg: CNN.FFDNetConfig, *, steps=200, batch=8, lr=1e-3,
                   size=64, sigmas=(15., 25., 50.), seed=0, qat=False,
                   quant: QuantConfig = BF16, device="cuda"):
    clean = synthetic.textures(256, size=size, seed=seed)
    params, _ = fit(CNN.ffdnet_descs(cfg), denoiser_loss(cfg, quant, qat),
                    denoiser_batches(clean, batch=batch, sigmas=sigmas,
                                     seed=seed),
                    steps=steps, lr=lr, seed=seed, device=device)
    return params


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

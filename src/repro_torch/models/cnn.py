"""The paper's application models: Keras-style CNN (Fig. 5), LeNet-5, and
FFDNet (Fig. 6) — with the custom approximate convolution layers.

Every conv/dense goes through the quant backend selected per model, so the
exact multiplier can be swapped for the approximate one exactly as in §5 of
the paper. The functional ``*_apply`` take a nested dict of tensors with
the JAX package's keys and layouts (HWIO conv weights, (in, out) dense
weights, NHWC activations); ``LeNet5``, ``KerasCNN`` and ``FFDNet`` are
``nn.Module`` wrappers that hold those parameters and call them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.convert import params_from_jax
from repro_torch.nn import conv as CV
from repro_torch.nn import layers as L
from repro_torch.nn.module import ParamDesc, init_params
from repro_torch.quant.quantize import BF16, QuantConfig


# ---------------------------------------------------------------------------
# Keras-style CNN (paper Fig. 5)
# ---------------------------------------------------------------------------

def keras_cnn_descs(n_classes: int = 10):
    return {
        "c1": CV.conv2d_desc(1, 32, 3),
        "c2": CV.conv2d_desc(32, 64, 3),
        "fc1": {"w": ParamDesc((7 * 7 * 64, 128), (None, None)),
                "b": ParamDesc((128,), (None,), "zeros")},
        "fc2": {"w": ParamDesc((128, n_classes), (None, None)),
                "b": ParamDesc((n_classes,), (None,), "zeros")},
    }


def keras_cnn_apply(params, x, quant: QuantConfig = BF16, qat=False):
    x = CV.conv2d(params["c1"], x, quant, qat=qat, activation="relu")
    x = CV.maxpool2(x)
    x = CV.conv2d(params["c2"], x, quant, qat=qat, activation="relu")
    x = CV.maxpool2(x)
    x = x.reshape(x.shape[0], -1)
    x = L.dense(params["fc1"], x, quant, qat=qat, activation="relu")
    return L.dense(params["fc2"], x, quant, qat=qat)


# ---------------------------------------------------------------------------
# LeNet-5 (paper Table 5)
# ---------------------------------------------------------------------------

def lenet5_descs(n_classes: int = 10):
    return {
        "c1": CV.conv2d_desc(1, 6, 5),
        "c2": CV.conv2d_desc(6, 16, 5),
        "fc1": {"w": ParamDesc((7 * 7 * 16, 120), (None, None)),
                "b": ParamDesc((120,), (None,), "zeros")},
        "fc2": {"w": ParamDesc((120, 84), (None, None)),
                "b": ParamDesc((84,), (None,), "zeros")},
        "fc3": {"w": ParamDesc((84, n_classes), (None, None)),
                "b": ParamDesc((n_classes,), (None,), "zeros")},
    }


def lenet5_apply(params, x, quant: QuantConfig = BF16, qat=False):
    x = CV.conv2d(params["c1"], x, quant, qat=qat, activation="relu")
    x = CV.avgpool2(x)
    x = CV.conv2d(params["c2"], x, quant, qat=qat, activation="relu")
    x = CV.avgpool2(x)
    x = x.reshape(x.shape[0], -1)
    x = L.dense(params["fc1"], x, quant, qat=qat, activation="relu")
    x = L.dense(params["fc2"], x, quant, qat=qat, activation="relu")
    return L.dense(params["fc3"], x, quant, qat=qat)


# ---------------------------------------------------------------------------
# FFDNet (paper Fig. 6): reversible downsample -> conv stack -> upsample
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FFDNetConfig:
    depth: int = 8
    width: int = 64
    channels: int = 1


def ffdnet_descs(cfg: FFDNetConfig = FFDNetConfig()):
    cin = cfg.channels * 4 + 1                     # unshuffled + noise map
    d: Dict[str, Any] = {"in": CV.conv2d_desc(cin, cfg.width, 3)}
    for i in range(cfg.depth - 2):
        d[f"mid{i}"] = CV.conv2d_desc(cfg.width, cfg.width, 3)
    d["out"] = CV.conv2d_desc(cfg.width, cfg.channels * 4, 3)
    return d


def pixel_unshuffle(x):
    """The JAX package's NHWC space-to-depth: channel index is
    (row parity, column parity, c). ``F.pixel_unshuffle`` is NCHW and
    orders channels differently."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def pixel_shuffle(x):
    """Inverse of ``pixel_unshuffle``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, 2, 2, c // 4)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * 2, w * 2, c // 4)


def ffdnet_apply(params, noisy, sigma, cfg: FFDNetConfig = FFDNetConfig(),
                 quant: QuantConfig = BF16, qat=False):
    """noisy: (B,H,W,C) in [0,1]; sigma: scalar or (B,) noise level /255."""
    x = pixel_unshuffle(noisy)
    sig = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    smap = sig.reshape(-1, 1, 1, 1).expand(x.shape[0], x.shape[1],
                                           x.shape[2], 1)
    x = torch.cat([x, smap], dim=-1)
    x = CV.conv2d(params["in"], x, quant, qat=qat, activation="relu")
    i = 0
    while f"mid{i}" in params:
        x = CV.conv2d(params[f"mid{i}"], x, quant, qat=qat,
                      activation="relu")
        i += 1
    x = CV.conv2d(params["out"], x, quant, qat=qat)
    return noisy - pixel_shuffle(x)                # residual: predict noise


# ---------------------------------------------------------------------------
# nn.Module wrappers
# ---------------------------------------------------------------------------

def _to_module(tree) -> nn.Module:
    """Two-level parameter tree (layer -> {"w", "b"}) as frozen modules."""
    return nn.ModuleDict({
        layer: nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                                 for name, t in leaves.items()})
        for layer, leaves in tree.items()})


class _Model(nn.Module):
    """Holds a parameter tree (``self.params``, keyed as in the JAX
    package), drawn by ``init_params`` unless ``params`` are given.
    ``forward`` runs under inference mode; training goes through
    ``train.cnn_train`` on the functional ``*_apply``."""

    def __init__(self, descs, generator, device, params):
        super().__init__()
        if params is None:
            params = init_params(
                descs, generator or torch.Generator().manual_seed(0), device)
        self.params = _to_module(params)

    @classmethod
    def from_jax(cls, np_tree, device="cuda"):
        """Build from the JAX package's parameter pytree (numpy leaves)."""
        return cls(params=params_from_jax(np_tree, device=device))


class LeNet5(_Model):
    def __init__(self, generator: torch.Generator = None, device="cuda",
                 params=None):
        super().__init__(lenet5_descs(), generator, device, params)

    @torch.inference_mode()
    def forward(self, x, quant: QuantConfig = BF16, qat=False):
        return lenet5_apply(self.params, x, quant, qat)


class KerasCNN(_Model):
    def __init__(self, generator: torch.Generator = None, device="cuda",
                 params=None):
        super().__init__(keras_cnn_descs(), generator, device, params)

    @torch.inference_mode()
    def forward(self, x, quant: QuantConfig = BF16, qat=False):
        return keras_cnn_apply(self.params, x, quant, qat)


class FFDNet(_Model):
    def __init__(self, cfg: FFDNetConfig = FFDNetConfig(),
                 generator: torch.Generator = None, device="cuda",
                 params=None):
        super().__init__(ffdnet_descs(cfg), generator, device, params)
        self.cfg = cfg

    @classmethod
    def from_jax(cls, np_tree, cfg: FFDNetConfig = FFDNetConfig(),
                 device="cuda"):
        return cls(cfg, params=params_from_jax(np_tree, device=device))

    @torch.inference_mode()
    def forward(self, noisy, sigma, quant: QuantConfig = BF16, qat=False):
        return ffdnet_apply(self.params, noisy, sigma, self.cfg, quant, qat)

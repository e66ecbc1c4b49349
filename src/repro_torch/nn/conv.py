"""Convolution layers with approximate-multiplier backends (the paper's
"custom convolution layer"). Quantized convs lower to im2col + quantized
matmul, so the same integer backends serve conv and dense layers — and the
CUDA kernels cover both. Layouts are the JAX package's: NHWC activations,
HWIO weights.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.nn.layers import relu
from repro_torch.nn.module import ParamDesc
from repro_torch.quant.matmul import quantized_matmul
from repro_torch.quant.quantize import QuantConfig, fake_quant_per_channel


def conv2d_desc(c_in: int, c_out: int, k: int = 3, dtype=torch.float32,
                bias: bool = True):
    d = {"w": ParamDesc((k, k, c_in, c_out), (None, None, "conv_io", None),
                        dtype=dtype)}
    if bias:
        d["b"] = ParamDesc((c_out,), (None,), "zeros", dtype=dtype)
    return d


def im2col(x: torch.Tensor, k: int, stride: int = 1,
           padding: str = "SAME") -> Tuple[torch.Tensor, Tuple[int, int]]:
    """x: (B,H,W,C) -> patches (B*Ho*Wo, k*k*C) in the JAX package's patch
    order (B, Ho, Wo, k, k, C) — not ``F.unfold``'s (C, k, k)."""
    b, h, w, c = x.shape
    if padding == "SAME":
        p = k // 2
        x = Fn.pad(x, (0, 0, p, p, p, p))
    ho = (x.shape[1] - k) // stride + 1
    wo = (x.shape[2] - k) // stride + 1
    dev = x.device
    idx_h = torch.arange(ho, device=dev) * stride
    idx_w = torch.arange(wo, device=dev) * stride
    ar = torch.arange(k, device=dev)
    patches = x[:, idx_h[:, None, None, None] + ar[None, :, None, None],
                idx_w[None, None, :, None] + ar[None, None, None, :], :]
    # (B, Ho, k, Wo, k, C) -> (B, Ho, Wo, k, k, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5)
    return patches.reshape(b * ho * wo, k * k * c), (ho, wo)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 (its default allows TF32, which
    keeps about three decimal digits); the flag is restored on exit."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _float_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                padding: str) -> torch.Tensor:
    """NHWC x HWIO float32 convolution through ``F.conv2d`` (NCHW/OIHW),
    with TF32 off for this call whatever the global flag says."""
    k_h, k_w = w.shape[0], w.shape[1]
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pads(x.shape[1], k_h, stride)
        pw = _same_pads(x.shape[2], k_w, stride)
        xn = Fn.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    with no_tf32():
        y = Fn.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def conv2d(params, x: torch.Tensor, quant: QuantConfig, stride: int = 1,
           padding: str = "SAME", qat: bool = False,
           activation: str = None) -> torch.Tensor:
    """x: (B,H,W,Cin) -> (B,Ho,Wo,Cout) via the selected backend.

    qat=True fake-quantizes the weight per output channel (STE) and runs
    the float convolution, whatever the backend.

    activation (None | 'relu') rides the quantized_matmul epilogue: for
    fused backends the dequant + bias + ReLU run inside the CUDA kernel on
    the im2col patches, whose (B, Ho*Wo, k*k*Cin) shape hands the batch to
    the kernel as part of its row axis."""
    w = params["w"]
    k, _, c_in, c_out = w.shape
    b = x.shape[0]
    if quant.is_quantized and not qat:
        cols, (ho, wo) = im2col(x, k, stride, padding)
        y = quantized_matmul(cols.reshape(b, ho * wo, k * k * c_in),
                             w.reshape(k * k * c_in, c_out), quant,
                             bias=params.get("b"), activation=activation)
        return y.reshape(b, ho, wo, c_out)
    wq = fake_quant_per_channel(w, axis=-1) if qat else w
    y = _float_conv(x, wq, stride, padding)
    if "b" in params:
        y = y + params["b"]
    if activation == "relu":
        y = relu(y)
    return y


def batchnorm_desc(c: int, dtype=torch.float32):
    return {"scale": ParamDesc((c,), (None,), "ones", dtype=dtype),
            "bias": ParamDesc((c,), (None,), "zeros", dtype=dtype),
            "mean": ParamDesc((c,), (None,), "zeros", dtype=dtype),
            "var": ParamDesc((c,), (None,), "ones", dtype=dtype)}


def batchnorm(params, x: torch.Tensor, training: bool = False,
              momentum: float = 0.9, eps: float = 1e-5):
    """Returns (y, new_stats) over the channel (last) axis. Training
    normalizes by the batch's mean and population variance and moves the
    running stats toward them by ``1 - momentum``; inference uses the
    stored running stats and returns them unchanged."""
    if training:
        red = tuple(range(x.ndim - 1))
        mu = x.mean(dim=red)
        var = x.var(dim=red, unbiased=False)
        new = {"mean": momentum * params["mean"] + (1 - momentum) * mu,
               "var": momentum * params["var"] + (1 - momentum) * var}
    else:
        mu, var = params["mean"], params["var"]
        new = {"mean": params["mean"], "var": params["var"]}
    y = (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y, new


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def avgpool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))

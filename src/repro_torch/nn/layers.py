"""Dense layer with quantized/approximate backends (the CNN heads)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.module import ParamDesc
from repro_torch.quant.matmul import quantized_matmul
from repro_torch.quant.quantize import QuantConfig, fake_quant_per_channel


def dense_desc(d_in: int, d_out: int, logical=("embed", "mlp"),
               dtype=torch.float32, bias: bool = False, scale=None):
    d = {"w": ParamDesc((d_in, d_out), logical, "normal", scale, dtype)}
    if bias:
        d["b"] = ParamDesc((d_out,), (logical[1],), "zeros", None, dtype)
    return d


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def dense(params, x: torch.Tensor, quant: QuantConfig, qat: bool = False,
          activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w (+ b)), executed per the quant backend.

    qat=True runs fake-quant (float ops, STE) — used when *training* a model
    that will deploy on the approximate multiplier.

    activation (None | 'relu') is threaded into quantized_matmul so
    backends with a fused epilogue run dequant + bias + activation
    in-kernel; the float path applies it after the bias add.
    """
    w = params["w"]
    if quant.is_quantized and not qat:
        return quantized_matmul(x, w, quant, bias=params.get("b"),
                                activation=activation)
    if qat:
        w = fake_quant_per_channel(w, axis=-1)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    if activation == "relu":
        y = relu(y)
    return y

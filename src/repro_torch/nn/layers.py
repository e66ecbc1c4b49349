"""Core layers: dense (with quantized/approximate backends), norms,
embeddings, the LM head and activations, after the JAX package's
``repro.nn.layers``. Norms compute in float32 and cast back; GELU is the
tanh form, ``jax.nn.gelu``'s default."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_desc(dim: int, dtype=torch.float32):
    return {"scale": ParamDesc((dim,), ("embed",), "ones", None, dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return y.to(dtype)


def layernorm_desc(dim: int, dtype=torch.float32):
    return {"scale": ParamDesc((dim,), ("embed",), "ones", None, dtype),
            "bias": ParamDesc((dim,), ("embed",), "zeros", None, dtype)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) + params["bias"].to(
        torch.float32)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_desc(vocab: int, dim: int, dtype=torch.float32):
    return {"table": ParamDesc((vocab, dim), ("vocab", "embed"), "embed",
                               0.02, dtype)}


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def logits(params, x: torch.Tensor, true_vocab: Optional[int] = None,
           quant: Optional[QuantConfig] = None,
           qat: bool = False) -> torch.Tensor:
    """x @ table.T in float32, with the padded vocab entries masked to the
    float32 minimum.

    A quantized ``quant`` runs the projection through the backend registry
    like every other LM matmul (the head is the widest projection of the
    stack). Under QAT (``qat=True``) it mirrors ``dense``: a float matmul
    over the fake-quantized table (per-vocab-row scales, the deployed
    per-channel quantization of ``table.T``)."""
    table = params["table"]
    if qat:
        table = fake_quant_per_channel(table, axis=0)   # per vocab row
        out = torch.matmul(x.to(torch.float32), table.to(torch.float32).t())
    elif quant is not None and quant.is_quantized:
        out = quantized_matmul(x, table.t(), quant).to(torch.float32)
    else:
        out = torch.matmul(x.to(torch.float32), table.to(torch.float32).t())
    if true_vocab is not None and true_vocab < out.shape[-1]:
        mask = torch.arange(out.shape[-1], device=out.device) < true_vocab
        out = torch.where(mask, out, torch.finfo(torch.float32).min)
    return out


# ---------------------------------------------------------------------------
# Activations / misc
# ---------------------------------------------------------------------------

def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, which ``jax.nn.gelu`` computes by default."""
    return F.gelu(x, approximate="tanh")


def softmax_cross_entropy(logits_: torch.Tensor, labels: torch.Tensor,
                          true_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean CE over non-negative labels (-1 = padding)."""
    logits_ = logits_.to(torch.float32)
    lse = torch.logsumexp(logits_, dim=-1)
    ll = torch.gather(logits_, -1,
                      labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = (lse - ll) * mask
    return loss.sum() / torch.clamp_min(mask.sum(), 1.0)

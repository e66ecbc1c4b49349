"""Symmetric int8 quantization, with straight-through-estimator training.

Range is clamped to [-127, 127] (not -128) so magnitudes fit the unsigned
8x8 core of the approximate multiplier via sign-magnitude. The codes are
bitwise those of the JAX package: the scale is max(amax, 1e-8) / 127 in
float32, ``quantize`` divides (it does not multiply by a reciprocal), and
``torch.round`` rounds half to even as ``jnp.round`` does. ``fake_quant``
is the JAX package's ``custom_vjp`` as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import dataclasses

import torch

QMAX = 127.0


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantized-execution config for dense/conv layers.

    backend names resolve through the registry in repro_torch.quant.matmul
    (`register_backend` / `list_backends`). Built-ins:
      'bf16'                  no quantization (float32 reference path)
      'int8_exact'            W8A8 symmetric, exact integer products
      'approx_lut'            W8A8, products via the approximate-multiplier
                              LUT (paper-faithful reference)
      'approx_deficit'        W8A8, deficit-plane formulation (bit-identical
                              to approx_lut; gather-free torch reference)
      'approx_stage1'         beyond-paper: exact matmul minus stage-1
                              rank-1 corrections (cheaper re-approximation)
      'approx_stage1_fused'   bit-identical to approx_stage1, 4 matmuls
      'approx_rank1'          bit-identical to approx_lut via the exact
                              rank-factored correction GEMM
      'approx_deficit_pallas' CUDA deficit kernel, bit-identical to
                              approx_lut; fused dequant/bias/ReLU epilogue
      'approx_stage1_pallas'  CUDA stage-1 kernel, fused epilogue
      'approx_rank1_pallas'   CUDA rank-factored kernel, fused epilogue
      'msr4[_lut]'            MSR-4 weight compression: weights decode to a
                              5-bit mantissa << 2-bit shift, activations
                              exact (core/truncation.py; '_lut' = the gate
                              reference, 'msr4' = decode + one exact dot)
      'drum6[_lut]'           DRUM-style dynamic truncation of both
                              operands to 6 significant bits with
                              forced-one (unbiased) rounding
      'posneg[_lut]'          Positive/Negative asymmetric truncation:
                              positive product classes floor to 4
                              significant bits, negative to 6
    (the ``_pallas`` names are kept so every row lines up with the JAX
    package's registry).

    fuse_epilogue: let backends with an in-kernel epilogue run dequant,
    bias add and activation fused (set False to force the unfused
    composition, e.g. for parity checks).

    act_scale: 'per_tensor' (one dynamic scale over the activation) or
    'per_token' (one per activation row).
    """
    backend: str = "bf16"
    multiplier: str = "proposed"       # compressor design for approx paths
    structure: str = "proposed"        # multiplier structure
    per_channel: bool = True           # weight scales per output channel
    act_scale: str = "per_tensor"      # 'per_tensor' | 'per_token'
    stochastic_round: bool = False
    fuse_epilogue: bool = True

    @property
    def is_quantized(self) -> bool:
        return self.backend != "bf16"

    @property
    def is_approx(self) -> bool:
        return self.backend.startswith("approx")


BF16 = QuantConfig()
INT8 = QuantConfig(backend="int8_exact")
APPROX_LUT = QuantConfig(backend="approx_lut")
APPROX_DEFICIT = QuantConfig(backend="approx_deficit")
APPROX_STAGE1 = QuantConfig(backend="approx_stage1")
APPROX_RANK1 = QuantConfig(backend="approx_rank1")
APPROX_DEFICIT_PALLAS = QuantConfig(backend="approx_deficit_pallas")
APPROX_STAGE1_PALLAS = QuantConfig(backend="approx_stage1_pallas")
APPROX_RANK1_PALLAS = QuantConfig(backend="approx_rank1_pallas")
MSR4 = QuantConfig(backend="msr4")
DRUM6 = QuantConfig(backend="drum6")
POSNEG = QuantConfig(backend="posneg")


def abs_max_scale(x: torch.Tensor, axis=None,
                  keepdims: bool = True) -> torch.Tensor:
    """max(|x|, 1e-8) / 127 over ``axis`` (all axes when None)."""
    if axis is None:
        amax = x.abs().amax()
        if keepdims:
            amax = amax.reshape((1,) * x.ndim)
    else:
        amax = x.abs().amax(dim=axis, keepdim=keepdims)
    return torch.clamp_min(amax, 1e-8) / QMAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric quantization to int8 in [-127, 127]."""
    q = torch.round(x / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def quantize_dynamic(x: torch.Tensor, axis=None):
    """(int8 values, scale). Per-tensor if axis is None else per-axis."""
    scale = abs_max_scale(x, axis=axis, keepdims=True)
    return quantize(x, scale), scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize; the backward is the straight-through estimator
    with range masking: the gradient passes where |x| <= scale * 127, and
    ``scale`` gets a zero gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        q = torch.clamp(torch.round(x / scale), -QMAX, QMAX)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        mask = (x.abs() <= scale * QMAX).to(g.dtype)
        return g * mask, torch.zeros_like(scale)


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradients (QAT)."""
    return _FakeQuant.apply(x, scale)


def fake_quant_per_channel(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """QAT fake-quant with one scale per index of ``axis`` (the output
    channel), reduced over every other axis."""
    red = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    scale = abs_max_scale(w, axis=red, keepdims=True)
    return fake_quant(w, scale)

"""Bindings the ``*_pallas`` registry entries call (quant/matmul.py): the
same contract as the torch backends (int8 in, int32 out), plus ``*_fused``
variants that run the dequant / bias / ReLU epilogue in-kernel and accept
a leading batch dim. CUDA tensors launch the kernels; CPU tensors take
their plain versions."""
from __future__ import annotations

import torch

from repro_torch.kernels import approx_matmul as K


def approx_matmul(x_q: torch.Tensor, w_q: torch.Tensor, cfg) -> torch.Tensor:
    """Bit-exact approximate-multiplier matmul (paper semantics)."""
    return K.approx_matmul(x_q, w_q, design=cfg.multiplier, kernel="deficit")


def stage1_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Beyond-paper re-approximation (stage-1 errors only)."""
    return K.approx_matmul(x_q, w_q, kernel="stage1")


def approx_matmul_fused(x_q, w_q, cfg, scale, bias, relu=False):
    """Deficit kernel with fused dequant(+bias)(+ReLU) epilogue."""
    return K.fused_matmul(x_q, w_q, scale, bias, design=cfg.multiplier,
                          variant="deficit", relu=relu)


def stage1_matmul_fused(x_q, w_q, cfg, scale, bias, relu=False):
    """Stage-1 kernel with fused dequant(+bias)(+ReLU) epilogue."""
    return K.fused_matmul(x_q, w_q, scale, bias, variant="stage1", relu=relu)


def rank1_matmul(x_q: torch.Tensor, w_q: torch.Tensor, cfg) -> torch.Tensor:
    """Bit-exact rank-factored matmul (paper semantics)."""
    return K.rank1_matmul(x_q, w_q, design=cfg.multiplier)


def rank1_matmul_fused(x_q, w_q, cfg, scale, bias, relu=False):
    """Rank-factored kernel with fused dequant(+bias)(+ReLU) epilogue."""
    return K.rank1_fused_matmul(x_q, w_q, scale, bias, design=cfg.multiplier,
                                relu=relu)

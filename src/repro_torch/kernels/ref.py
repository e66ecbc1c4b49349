"""Small torch oracles for the CUDA kernels (the bit-exact ground truth)."""
from __future__ import annotations

import torch

from repro_torch.core import luts
from repro_torch.core.multiplier import MultiplierConfig, proposed_multiplier


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 dot of int8 codes over the last axis of ``x_q``.

    Runs in float64, which holds every partial sum exactly
    (|sum| <= K * 127^2 < 2^53) whatever the order or the TF32 flags; the
    card has no int32 matmul. This is the plain versions' exact dot; it is
    never the product inside a kernel."""
    y = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return y.to(torch.int64).to(torch.int32)


def approx_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                      mult_cfg: MultiplierConfig | None = None
                      ) -> torch.Tensor:
    """out[m,n] = sum_k signedLUT(x[m,k], w[k,n]); int8 in, int32 out.

    Small-shape oracle (materializes (M,K,N) int32)."""
    mult_cfg = mult_cfg or proposed_multiplier("proposed")
    tbl = torch.as_tensor(luts.signed_product_lut(mult_cfg),
                          device=x_q.device)
    xi = x_q.to(torch.int64) & 0xFF
    wi = w_q.to(torch.int64) & 0xFF
    prods = tbl[xi[:, :, None], wi[None, :, :]]
    return prods.sum(dim=1).to(torch.int32)


def stage1_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Oracle for the stage-1-corrected (beyond-paper) kernel."""
    from repro_torch.quant.matmul import approx_matmul_stage1
    from repro_torch.quant.quantize import QuantConfig
    return approx_matmul_stage1(x_q, w_q,
                                QuantConfig(backend="approx_stage1"))

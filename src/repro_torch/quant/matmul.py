"""Quantized matmul execution backends — a pluggable registry.

All integer backends share the contract:
    out_int32[m, n] = sum_k  P(x_q[m, k], w_q[k, n])
where P is the (possibly approximate) signed product of two int8 values in
[-127, 127]. Built-in entries (see `list_backends()`), registered in the
JAX package's order so that every artifact row lines up:

  int8_exact            P = a * b
  approx_lut            P = sign * LUT_u8(|a|, |b|)      (paper-faithful)
  approx_deficit        P = a*b - sign * deficit(|a|,|b|) (bit-identical to
                        LUT; gather-free)
  approx_stage1         P = a*b - sign * stage1_err(|a|,|b|) (beyond-paper:
                        only the rank-1 stage-1 compressor errors, 8 dots)
  approx_stage1_fused   bit-identical to approx_stage1 in 4 dots
  approx_rank1          P identical to approx_lut: exact dot minus the
                        rank-factored correction GEMM (core/factor.py)
  approx_deficit_pallas CUDA deficit kernel (bit-identical to approx_lut);
                        fused dequant/bias/ReLU epilogue, batched rows
  approx_stage1_pallas  CUDA stage-1 kernel (bit-identical to
                        approx_stage1); fused epilogue likewise
  approx_rank1_pallas   CUDA rank-factored kernel (bit-identical to
                        approx_lut); fused epilogue likewise
  msr4_lut / msr4       MSR-4 weight compression (core/truncation.py):
                        weights decode to 5-bit mantissa << 2-bit shift,
                        activations stay exact. `_lut` is the gate-level
                        gather reference; `msr4` is decode + 1 exact dot.
  drum6_lut / drum6     DRUM-style dynamic truncation to 6 significant
                        bits per operand with forced-one debias; core is
                        one dot over truncated operands.
  posneg_lut / posneg   Positive/Negative asymmetric floor truncation:
                        k=4 for positive product classes, k=6 for
                        negative; core is 4 masked dots.

The ``*_pallas`` names are the JAX package's; here they bind to the CUDA
kernels of repro_torch.kernels (their plain versions on CPU tensors).

Every dot outside the kernels runs in float64 (`int8_matmul`), or in
float32 where the operands and every partial sum are small integers, so
the integer results hold whatever the TF32 flags say.

Backward is always the straight-through estimator (exact float grads),
which is how the paper trains its Keras models (forward substitution
only): `quantized_matmul` is a `torch.autograd.Function` whose forward
runs the selected backend and whose backward is float matmuls.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import factor as factorlib
from repro_torch.core import luts, truncation
from repro_torch.core.factor import STAGE1_SITES
from repro_torch.core.multiplier import MultiplierConfig
from repro_torch.kernels import approx_matmul as KA
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import int8_matmul
from repro_torch.quant import truncated as _truncated
from repro_torch.quant.quantize import QuantConfig, abs_max_scale, quantize


@lru_cache(maxsize=16)
def _err_lut_cached(mult_cfg: MultiplierConfig) -> np.ndarray:
    """(65536,) int16 signed-product error table indexed by
    (a & 0xFF) * 256 + (b & 0xFF) for signed int8 a, b."""
    signed = luts.signed_product_lut(mult_cfg)       # (256,256) int32
    vals = np.arange(256)
    sval = np.where(vals < 128, vals, vals - 256)
    exact = sval[:, None] * sval[None, :]
    return (signed - exact).astype(np.int16).reshape(-1)


@lru_cache(maxsize=16)
def _err_lut_device(mult_cfg: MultiplierConfig, device: str) -> torch.Tensor:
    """The error table staged once per config and device."""
    return torch.as_tensor(_err_lut_cached(mult_cfg), device=device)


def _mult_cfg(cfg: QuantConfig) -> MultiplierConfig:
    return MultiplierConfig(name=f"{cfg.structure}[{cfg.multiplier}]",
                            compressor=cfg.multiplier,
                            structure=cfg.structure)


def _bytes_index(t: torch.Tensor) -> torch.Tensor:
    """The operand's byte as a gather index: int8 -> uint8 wrap, made
    explicit (the reference's ``astype(jnp.uint8)``)."""
    return t.to(torch.int32) & 0xFF


# ---------------------------------------------------------------------------
# Integer matmul backends (torch; the CUDA kernels are the *_pallas entries)
# ---------------------------------------------------------------------------

def _approx_error_lut(x_q, w_q, err_flat, budget=None):
    """sum_k E[x[m,k], w[k,n]] via gather, in (rows, cols) chunks
    (``kernels.approx_matmul.chunk_rows``)."""
    m, k = x_q.shape
    n = w_q.shape[1]
    xi = _bytes_index(x_q)
    wi = _bytes_index(w_q)
    rows, cols = KA.chunk_rows(k, n, x_q.device, budget)

    def part(r0, r1, c0, c1):
        idx = xi[r0:r1, :, None] * 256 + wi[None, :, c0:c1]     # int32
        return err_flat[idx].sum(dim=1, dtype=torch.int32)

    return KA._tiled(m, n, rows, cols, part, torch.int32, x_q.device)


def approx_matmul_lut(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
    """Bit-exact approximate matmul via the signed error LUT."""
    err = _err_lut_device(_mult_cfg(cfg), str(x_q.device))
    return int8_matmul(x_q, w_q) + _approx_error_lut(x_q, w_q, err)


def approx_matmul_deficit(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
    """Bit-exact approximate matmul via the deficit identity
    (``core.deficit``): the exact dot minus the signed deficit sums. Only
    the 'proposed' structure has the identity."""
    if cfg.structure != "proposed":
        raise ValueError(f"approx_deficit needs structure 'proposed', got "
                         f"{cfg.structure!r}")
    return KA.approx_matmul_plain(x_q, w_q, cfg.multiplier, "deficit")


def approx_matmul_stage1(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
    """Beyond-paper re-approximation: exact matmul minus the rank-1
    stage-1 site corrections (each an extra dot)."""
    return KA.approx_matmul_plain(x_q, w_q, kernel="stage1")


def approx_matmul_stage1_fused(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
    """Stage-1 correction with sites that share an operand window merged
    by weighting the other side: 1 + 3 dots instead of 1 + 7.
    Bit-identical to approx_matmul_stage1:
      sites (5,0,2),(6,0,3),(7,0,4)  share the a-window rows 0-3
      sites (8,1,4),(9,2,4),(10,3,4) share the b-window rows 4-7
    The weighted features have at most 3 significant bits (|v| <= 1792), so
    they are exact in float32 and in TF32 alike, and every float32 partial
    sum stays an integer below 2^24 for K < 9362.
    """
    out = int8_matmul(x_q, w_q)
    xs = x_q.to(torch.int32)
    ws = w_q.to(torch.int32)
    xsgn, wsgn = xs.sign(), ws.sign()
    xmag, wmag = xs.abs(), ws.abs()

    def f32mm(u, v):
        return torch.matmul(u.to(torch.float32),
                            v.to(torch.float32)).to(torch.int32)

    # group A: shared u = AND(a bits 0..3); v = sum_c 2^c * v_c
    uA = KA.window_and(xmag, 0) * xsgn
    vA = sum((KA.window_and(wmag, rb) << col)
             for col, ra, rb in STAGE1_SITES[:3]) * wsgn
    out = out - f32mm(uA, vA)
    # singleton site (7, 4, 0)
    col, ra, rb = STAGE1_SITES[3]
    out = out - (int8_matmul(KA.window_and(xmag, ra) * xsgn,
                             KA.window_and(wmag, rb) * wsgn) << col)
    # group B: shared v = AND(b bits 4..7); u = sum_c 2^c * u_c
    uB = sum((KA.window_and(xmag, ra) << col)
             for col, ra, rb in STAGE1_SITES[4:]) * xsgn
    vB = KA.window_and(wmag, 4) * wsgn
    return out - f32mm(uB, vB)


def rank1_info(design: str) -> Dict:
    """Correction-complexity summary for one design (profiles):
    R (factor count), exact rank, digit planes, f32-exact K bound."""
    fac = factorlib.factorize(design)
    return {"R": fac.R, "rank": fac.rank, "digits": fac.n_digits,
            "k_exact_f32": fac.k_exact_f32,
            "stage1_terms": len(fac.stage1)}


def approx_matmul_rank1(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
    """Bit-exact approximate matmul as exact dot + rank-factored correction
    GEMM (``core.factor``), in float64 where every partial sum is an exact
    integer, so TF32 never applies."""
    return KA.rank1_matmul_plain(x_q, w_q, cfg.multiplier)


def stage1_exhaustive_products() -> np.ndarray:
    """(256, 256) int64 product table of the stage-1 re-approximation over
    the unsigned 8x8 domain: a*b minus every STAGE1_SITES correction whose
    4-bit operand windows are all ones."""
    a = np.arange(256, dtype=np.int64)
    out = a[:, None] * a[None, :]
    for col, ra, rb in STAGE1_SITES:
        ua = np.ones(256, np.int64)
        for i in range(ra, ra + 4):
            ua &= (a >> i) & 1
        ub = np.ones(256, np.int64)
        for i in range(rb, rb + 4):
            ub &= (a >> i) & 1
        out = out - ((ua[:, None] * ub[None, :]) << col)
    return out


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    """One integer-matmul execution path.

    fn:     (x_q (M,K) int8, w_q (K,N) int8, cfg) -> (M,N) int32 — the
            pre-dequant contract shared by every backend.
    grad:   backward rule; only 'ste' (straight-through, exact float grads)
            is defined.
    fused:  optional (x_q (B,M,K)|(M,K), w_q, cfg, scale (1,N) f32,
            bias (1,N) f32, relu: bool) -> f32 — integer matmul with the
            dequant/bias/ReLU epilogue fused (the CUDA kernels). When set,
            `quantized_matmul` routes through it and batched leading dims
            hit the kernel directly.
    oracle: name of the registered backend this entry must bit-match
            pre-dequant.
    note:   one-line description for benchmarks/docs.
    """
    name: str
    fn: Callable[[torch.Tensor, torch.Tensor, QuantConfig], torch.Tensor]
    grad: str = "ste"
    fused: Optional[Callable] = None
    oracle: Optional[str] = None
    note: str = ""


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, fn: Callable, *, grad: str = "ste",
                     fused: Optional[Callable] = None,
                     oracle: Optional[str] = None, note: str = "") -> Backend:
    """Register an integer-matmul backend under `name`.

    `name` must be new; `oracle` must name an already-registered backend;
    `grad` must be 'ste', the only backward rule defined."""
    if grad != "ste":
        raise ValueError(f"unknown grad rule {grad!r}; only 'ste' is defined")
    if name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    if oracle is not None and oracle not in _REGISTRY:
        raise ValueError(f"backend {name!r} declares unknown oracle "
                         f"{oracle!r}; register the oracle first "
                         f"(registered: {list_backends()})")
    be = Backend(name=name, fn=fn, grad=grad, fused=fused, oracle=oracle,
                 note=note)
    _REGISTRY[name] = be
    return be


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown quant backend {name!r}; registered: "
                       f"{list_backends()}") from None


def list_backends() -> Tuple[str, ...]:
    """Registered backend names, in registration order."""
    return tuple(_REGISTRY)


def backend_notes() -> Dict[str, str]:
    """name -> one-line description, for reports."""
    return {name: be.note for name, be in _REGISTRY.items()}


register_backend("int8_exact", lambda x, w, cfg: int8_matmul(x, w),
                 note="W8A8 exact integer products")
register_backend("approx_lut", approx_matmul_lut,
                 note="paper-faithful signed-LUT emulation (gather-bound)")
register_backend("approx_deficit", approx_matmul_deficit,
                 oracle="approx_lut",
                 note="deficit-plane emulation, gather-free torch reference")
register_backend("approx_stage1", approx_matmul_stage1,
                 note="stage-1 rank-1 re-approximation (8 dots)")
register_backend("approx_stage1_fused", approx_matmul_stage1_fused,
                 oracle="approx_stage1",
                 note="stage-1 re-approximation in 4 dots")
register_backend("approx_rank1", approx_matmul_rank1,
                 oracle="approx_lut",
                 note="exact dot + rank-factored correction GEMM "
                      "(float64-exact, no deficit planes)")
register_backend("approx_deficit_pallas", kops.approx_matmul,
                 fused=kops.approx_matmul_fused, oracle="approx_lut",
                 note="CUDA deficit kernel + fused dequant/bias/ReLU "
                      "epilogue")
register_backend("approx_stage1_pallas",
                 lambda x, w, cfg: kops.stage1_matmul(x, w),
                 fused=kops.stage1_matmul_fused, oracle="approx_stage1",
                 note="CUDA stage-1 kernel + fused epilogue")
register_backend("approx_rank1_pallas", kops.rank1_matmul,
                 fused=kops.rank1_matmul_fused, oracle="approx_lut",
                 note="CUDA rank-factored kernel (shared-memory factor "
                      "tables) + fused epilogue")


# ---------------------------------------------------------------------------
# MSR/truncation family (core/truncation.py gate references +
# quant/truncated.py vectorized cores)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _trunc_err_device(kind: str, device: str) -> torch.Tensor:
    """The family member's flattened signed error table, staged once per
    device (same gather layout as `_err_lut_device`)."""
    return torch.as_tensor(truncation.error_table(kind), device=device)


def _trunc_lut_matmul(kind: str):
    """Gate-level gather reference for a truncation-family member: exact
    dot plus the exhaustive signed error table — the family's oracle,
    bit-identical to `core.truncation.product_table(kind)`."""
    def fn(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
        err = _trunc_err_device(kind, str(x_q.device))
        return int8_matmul(x_q, w_q) + _approx_error_lut(x_q, w_q, err)
    fn.__name__ = f"{kind}_lut_matmul"
    return fn


register_backend("msr4_lut", _trunc_lut_matmul("msr4"),
                 note="MSR-4 weight-compression gate reference "
                      "(signed-LUT gather)")
register_backend("msr4", _truncated.msr4_matmul, oracle="msr4_lut",
                 note="MSR-4 5-bit mantissa+shift weight decode + one "
                      "exact dot (weight-only approximation)")
register_backend("drum6_lut", _trunc_lut_matmul("drum6"),
                 note="DRUM-6 dynamic-truncation gate reference "
                      "(signed-LUT gather)")
register_backend("drum6", _truncated.drum6_matmul, oracle="drum6_lut",
                 note="DRUM-6: one dot over operands truncated to 6 "
                      "significant bits with forced-one debias")
register_backend("posneg_lut", _trunc_lut_matmul("posneg"),
                 note="Positive/Negative asymmetric-truncation gate "
                      "reference (signed-LUT gather)")
register_backend("posneg", _truncated.posneg_matmul, oracle="posneg_lut",
                 note="sign-classed floor truncation (k=4 positive / "
                      "k=6 negative product classes) as 4 masked dots")


def integer_matmul(x_q, w_q, cfg: QuantConfig) -> torch.Tensor:
    """Pre-dequant int32 matmul via the backend selected by cfg.backend."""
    return get_backend(cfg.backend).fn(x_q, w_q, cfg)


# ---------------------------------------------------------------------------
# Float-in/float-out quantized matmul with STE backward
# ---------------------------------------------------------------------------

def _float_epilogue(y, bias, activation):
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation == "relu":
        y = torch.clamp_min(y, 0.0)
    return y


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig,
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None) -> torch.Tensor:
    """y = act(dequant(integer_matmul(q(x), q(w))) + bias).

    x: (..., k), w: (k, n), bias: (n,) or None, activation: None | 'relu'.
    Backends whose registry entry defines a fused epilogue run dequant,
    bias and activation in-kernel (batched over the leading dims); all
    others use the unfused composition. The float order is the JAX
    package's: per-tensor fused ``acc * (sx*sw) + bias`` in the kernel;
    unfused ``acc * (sx*sw)``, then bias, then ReLU; per-token
    ``(acc * sw) * sx``, then bias and ReLU. Backward is the
    straight-through estimator either way.
    """
    if activation not in (None, "relu"):
        raise ValueError(f"unsupported activation {activation!r}")
    return _QuantizedMatmul.apply(x, w, bias, cfg, activation)


class _QuantizedMatmul(torch.autograd.Function):
    """The forward runs the backend (the CUDA kernels on the card); the
    backward is the JAX package's ``_qmm_grads``: the ReLU mask from the
    saved output, then float32 ``dx = g @ w.T``, ``dw = x.T @ g`` (cast
    to w's dtype) and ``db = sum(g)``."""

    @staticmethod
    def forward(ctx, x, w, bias, cfg, activation):
        y = _qmm_forward(x, w, bias, cfg, activation)
        ctx.activation = activation
        ctx.bias_like = (None if bias is None
                         else (bias.shape, bias.dtype))
        ctx.save_for_backward(x, w, y if activation == "relu" else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.activation == "relu":
            g = g * (y > 0).to(g.dtype)
        g2 = g.reshape(-1, w.shape[1]).to(torch.float32)
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        dx = (g2 @ w.to(torch.float32).t()).reshape(x.shape).to(x.dtype)
        dw = (x2.t() @ g2).to(w.dtype)
        db = None
        if ctx.bias_like is not None:
            shape, dtype = ctx.bias_like
            db = g2.sum(dim=0).reshape(shape).to(dtype)
        return dx, dw, db, None, None


def _qmm_forward(x, w, bias, cfg: QuantConfig, activation):
    """Shared quantize -> backend -> dequant/epilogue composition.

    Every backend gets contiguous int8 codes: elementwise ops keep their
    input's strides, so the codes of a transposed weight (the tied LM
    head's ``table.T``) would otherwise reach the CUDA kernels, which take
    contiguous operands only. The per-token epilogue keeps the JAX
    package's order (which it pins with ``_pin``): ``acc * sw`` (in the
    kernel on the fused route), then ``* sx``, then bias and activation."""
    backend = get_backend(cfg.backend)
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    per_token = cfg.act_scale == "per_token"
    if not per_token and cfg.act_scale != "per_tensor":
        raise ValueError(f"unknown act_scale {cfg.act_scale!r}; "
                         "choose 'per_tensor' or 'per_token'")
    if cfg.per_channel:
        sw = abs_max_scale(w, axis=0, keepdims=True)   # (1, n)
    else:
        sw = abs_max_scale(w)
    w_q = quantize(w, sw).contiguous()

    if backend.fused is not None and cfg.fuse_epilogue:
        # (B, T, K): leading dims become the kernel's batched rows
        x3 = x.reshape(-1, k) if x.ndim <= 2 else x.reshape(-1, x.shape[-2], k)
        zeros = torch.zeros((1, n), dtype=torch.float32, device=x.device)
        if per_token:
            sx = abs_max_scale(x3, axis=-1, keepdims=True)  # (..., M, 1)
            x_q = quantize(x3, sx).contiguous()
            scale = sw.to(torch.float32).reshape(1, -1).expand(1, n)
            y = backend.fused(x_q, w_q, cfg, scale.contiguous(), zeros,
                              False)
            y = _float_epilogue(y * sx, bias, activation)
        else:
            sx = abs_max_scale(x3, axis=None, keepdims=False)
            x_q = quantize(x3, sx).contiguous()
            scale = (sx * sw).reshape(1, -1).expand(1, n).contiguous()
            b_arr = (zeros if bias is None
                     else bias.to(torch.float32).reshape(1, n).contiguous())
            y = backend.fused(x_q, w_q, cfg, scale, b_arr,
                              activation == "relu")
    else:
        x2 = x.reshape(-1, k)
        sx = abs_max_scale(x2, axis=-1 if per_token else None,
                           keepdims=per_token)   # (M, 1) | scalar
        x_q = quantize(x2, sx).contiguous()
        acc = backend.fn(x_q, w_q, cfg).to(torch.float32)
        y = (acc * sw) * sx if per_token else acc * (sx * sw)
        y = _float_epilogue(y, bias, activation)
    return y.reshape(*lead, n).to(x.dtype)

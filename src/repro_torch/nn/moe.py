"""Mixture-of-Experts with sort-based capacity dispatch, after the JAX
package's ``repro.nn.moe``.

Dispatch is GShard-style with capacity dropping, implemented with a stable
sort and scatters (no (tokens, experts, capacity) one-hot tensor). It is
group-local, one group per sequence row of the call: capacity, sort and
scatter all happen within a row. The expert and shared-expert products are
float einsums with float32 accumulation, as in the reference (no Pallas
kernel runs them there either).

Two choices of the port that change no result:
  * only the experts that hold at least one kept token are multiplied; an
    expert with an empty buffer contributes nothing to the combine, which
    reads kept slots only;
  * the combine adds each chunk's contributions in rounds of distinct
    tokens, in the order of the sorted entries, so that a token that
    occurs twice in a chunk is summed in the same order on every device
    (a scatter-add with repeated indices has no defined order on the card).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.module import ParamDesc
from repro_torch.quant.quantize import (QMAX, QuantConfig,
                                        fake_quant_per_channel)

EXPERT_CHUNK = 32        # experts multiplied per batched product


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    int8_gather: bool = False      # quantize expert weights before the
    #                                FSDP all-gather (the reference's)


class _Q8Replicated(torch.autograd.Function):
    """The reference's ``int8_gather`` weights on one device: int8 codes
    with one scale per (expert, output channel), dequantized, and a
    straight-through gradient (no range mask)."""

    @staticmethod
    def forward(ctx, w):
        scale = (w.abs().amax(dim=1, keepdim=True).to(torch.float32) / QMAX
                 + 1e-12)
        q = torch.clamp(torch.round(w.to(torch.float32) / scale), -QMAX,
                        QMAX).to(torch.int8)
        return q.to(w.dtype) * scale.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def moe_desc(cfg: MoEConfig, dtype=torch.float32):
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    d = {
        "router": ParamDesc((D, E), ("embed", "experts"), scale=0.02,
                            dtype=torch.float32),
        "w1": ParamDesc((E, D, Fd), ("experts", "fsdp", "mlp"), dtype=dtype),
        "w3": ParamDesc((E, D, Fd), ("experts", "fsdp", "mlp"), dtype=dtype),
        "w2": ParamDesc((E, Fd, D), ("experts", "mlp", "fsdp"), dtype=dtype),
    }
    if cfg.n_shared:
        Fs = Fd * cfg.n_shared
        d["shared_w1"] = ParamDesc((D, Fs), ("fsdp", "mlp"), dtype=dtype)
        d["shared_w3"] = ParamDesc((D, Fs), ("fsdp", "mlp"), dtype=dtype)
        d["shared_w2"] = ParamDesc((Fs, D), ("mlp", "fsdp"), dtype=dtype)
    return d


def route(params, x: torch.Tensor, cfg: MoEConfig) -> dict:
    """The router and the group-local dispatch plan of ``x`` (B, S, D):
    top-k expert ids and normalized gates (B, S, K), the Switch aux loss,
    the capacity, and per sorted entry (B, S*K) its token, expert, gate,
    ``keep`` mask and buffer ``slot`` (E * cap is the drop slot)."""
    b, s, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    gk = s * K
    dev = x.device
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)      # (B, S, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # ---- aux load-balancing loss (Switch-style) ----
    me = probs.mean(dim=(0, 1))
    ce = torch.bincount(expert_ids.reshape(-1), minlength=E).to(
        torch.float32) / (b * gk)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    # ---- group-local sort-based dispatch with capacity ----
    cap = int(max(1, round(gk / E * cfg.capacity_factor)))
    se = expert_ids.reshape(b, gk)
    st = torch.arange(s, device=dev).repeat_interleave(K)[None].expand(b, gk)
    sg = gate_vals.reshape(b, gk)
    order = torch.argsort(se, dim=1, stable=True)
    se = torch.gather(se, 1, order)
    st = torch.gather(st, 1, order)
    sg = torch.gather(sg, 1, order)
    idx = torch.arange(gk, device=dev)[None].expand(b, gk)
    starts = torch.full((b, E), gk, dtype=torch.int64, device=dev)
    starts = starts.scatter_reduce(1, se, idx, "amin")
    pos_in_e = idx - torch.gather(starts, 1, se)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)
    return {"ids": expert_ids, "gates": gate_vals, "aux": aux, "cap": cap,
            "token": st, "expert": se, "gate": sg, "keep": keep,
            "slot": slot}


def _experts(params, cfg: MoEConfig, qat: bool):
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if cfg.int8_gather:
        return (_Q8Replicated.apply(w1), _Q8Replicated.apply(w3),
                _Q8Replicated.apply(w2))
    if qat:
        return (fake_quant_per_channel(w1, axis=-1),
                fake_quant_per_channel(w3, axis=-1),
                fake_quant_per_channel(w2, axis=-1))
    return w1, w3, w2


def _f32mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product in float32: the reference's
    ``preferred_element_type=float32`` (bf16 products are exact there)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def apply(params, x: torch.Tensor, cfg: MoEConfig, quant: QuantConfig,
          qat: bool = False):
    """x: (B, S, D) -> (out, aux_loss). ``quant`` is the layer's config;
    the experts run as float products under every backend, as in the
    reference. ``qat`` fake-quantizes the expert weights per channel."""
    del quant
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    r = route(params, x, cfg)
    cap, st, keep, slot, sg = (r["cap"], r["token"], r["keep"], r["slot"],
                               r["gate"])
    bidx = torch.arange(b, device=x.device)[:, None]

    # dispatch in K chunks of s entries: kept slots are distinct, so each
    # lands on a zero; the drop slot's sum is discarded
    buf = torch.zeros((b, E * cap + 1, d), dtype=x.dtype, device=x.device)
    for c0 in range(K):
        sl = slice(c0 * s, (c0 + 1) * s)
        buf.index_put_((bidx, slot[:, sl]), x[bidx, st[:, sl]],
                       accumulate=True)
    buf = buf[:, :-1].reshape(b, E, cap, d)

    w1, w3, w2 = _experts(params, cfg, qat)
    used = torch.nonzero(torch.bincount(
        r["expert"][keep], minlength=E))[:, 0].tolist()
    y = torch.zeros((b, E, cap, d), dtype=x.dtype, device=x.device)
    for i in range(0, len(used), EXPERT_CHUNK):
        e = torch.tensor(used[i:i + EXPERT_CHUNK], device=x.device)
        be = buf[:, e].transpose(0, 1).reshape(len(e), b * cap, d)
        h = _f32mm(be, w1[e])
        u = _f32mm(be, w3[e])
        act = (F.silu(h) * u).to(x.dtype)
        ye = _f32mm(act, w2[e]).to(x.dtype)
        y[:, e] = ye.reshape(len(e), b, cap, d).transpose(0, 1)

    y_flat = y.reshape(b, E * cap, d)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    for c0 in range(K):                     # combine in K chunks, as above
        sl = slice(c0 * s, (c0 + 1) * s)
        gathered = y_flat[bidx, torch.clamp(slot[:, sl], 0, E * cap - 1)]
        contrib = torch.where(keep[:, sl, None],
                              gathered * sg[:, sl, None].to(x.dtype),
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        _add_in_order(out, st[:, sl], contrib)

    if cfg.n_shared:
        hs = _f32mm(x, params["shared_w1"]).to(x.dtype)
        us = _f32mm(x, params["shared_w3"]).to(x.dtype)
        out = out + _f32mm((F.silu(hs) * us).to(x.dtype),
                           params["shared_w2"]).to(x.dtype)
    return out, r["aux"]


def _add_in_order(out: torch.Tensor, tok: torch.Tensor,
                  contrib: torch.Tensor) -> None:
    """out[b, tok[b, i]] += contrib[b, i] for every entry i, in the order
    of i, in place: round j adds the j-th occurrence of each token, and a
    round's tokens are distinct."""
    b, n = tok.shape
    same = tok[:, :, None] == tok[:, None, :]                  # (B, n, n)
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=tok.device).tril(-1)
    rank = (same & earlier).sum(dim=-1)                        # (B, n)
    for j in range(int(rank.max()) + 1 if n else 0):
        bi, ii = torch.nonzero(rank == j, as_tuple=True)
        ti = tok[bi, ii]
        out[bi, ti] = out[bi, ti] + contrib[bi, ii]

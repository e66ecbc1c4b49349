"""Attention: global grouped-query attention with RoPE, after the JAX
package's ``repro.nn.attention``.

Cache convention (per layer; stacked over the layers of a group by the
model): k/v (B, S_max, Hkv, Dh), written at each row's absolute positions.
``apply`` writes the cache in place (the JAX package returns an updated
copy) and returns it.

The attention math is plain PyTorch, as the JAX package leaves it to XLA
outside any Pallas kernel: blockwise online softmax in float32 over KV
chunks, masks rebuilt from absolute positions. It follows the reference's
order of operations rather than calling a fused library attention, so that
the two stacks' logits agree within a float32 bound.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the windowed ring buffer (gemma3), cross-attention (llama-3.2
vision) and absorbed MLA (deepseek-v2).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import layers as L
from repro_torch.nn.module import ParamDesc
from repro_torch.quant.quantize import QuantConfig

NEG = -2.0 ** 30
KV_CHUNK = 1024

NOT_PORTED = {
    "window": "windowed ring-buffer attention (gemma3) is not ported yet: "
              "ROADMAP.md queue A, item 16",
    "cross": "cross-attention (llama-3.2-vision) is not ported yet: "
             "ROADMAP.md queue A, item 19",
    "mla": "MLA attention (deepseek-v2) is not ported yet: ROADMAP.md "
           "queue A, item 17",
}


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: int = 0                  # 0 = global causal
    cross: bool = False              # kv from encoder states
    p_bf16: bool = False             # bf16 softmax weights for the PV dot
    # MLA (all zero -> standard GQA)
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head_dim: int = 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0


def check_ported(cfg: AttnConfig) -> None:
    """Raise for the attention variants this port does not run yet."""
    if cfg.is_mla:
        raise NotImplementedError(NOT_PORTED["mla"])
    if cfg.cross:
        raise NotImplementedError(NOT_PORTED["cross"])
    if cfg.window:
        raise NotImplementedError(NOT_PORTED["window"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Frequencies in float32, as the reference writes them."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def q_positions(pos, b: int, s: int, device) -> torch.Tensor:
    """Absolute positions of the current queries, one row per batch slot.

    pos None   -> prefill from 0 (every row 0..s-1)
    pos scalar -> uniform decode offset (the batch-synchronous case)
    pos (B,)   -> per-slot offsets (continuous batching: each slot of the
                  serving pool decodes at its own depth)
    Returns (B, s) int64 (the index dtype of torch).
    """
    base = torch.arange(s, dtype=torch.int64, device=device)[None, :]
    if pos is None:
        return base.expand(b, s)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    off = pos[None] if pos.ndim == 0 else pos
    return (off[:, None] + base).expand(b, s)


# ---------------------------------------------------------------------------
# Descriptors and cache
# ---------------------------------------------------------------------------

def attn_desc(cfg: AttnConfig, dtype=torch.float32):
    check_ported(cfg)
    D = cfg.d_model
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    d = {
        "wq": ParamDesc((D, qd), ("embed", "heads"), dtype=dtype),
        "wk": ParamDesc((D, kvd), ("embed", "kv_heads"), dtype=dtype),
        "wv": ParamDesc((D, kvd), ("embed", "kv_heads"), dtype=dtype),
        "wo": ParamDesc((qd, D), ("heads", "embed"), dtype=dtype),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDesc((qd,), ("heads",), "zeros", dtype=dtype)
        d["bk"] = ParamDesc((kvd,), ("kv_heads",), "zeros", dtype=dtype)
        d["bv"] = ParamDesc((kvd,), ("kv_heads",), "zeros", dtype=dtype)
    return d


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    check_ported(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, q_pos, k_pos, window: int, kv_chunk: int = KV_CHUNK,
          p_bf16: bool = False) -> torch.Tensor:
    """Blockwise (flash-style) attention: online softmax over KV chunks, so
    that no (Sq, Sk) score tensor over the whole cache is kept; chunk masks
    are rebuilt from absolute positions.

    q: (B,Sq,H,D) k/v: (B,Sk,Hkv,D[v]); q_pos (Sq,)/(B,Sq) and k_pos
    (Sk,)/(B,Sk) with -1 marking invalid slots — a full (B, S) position
    matrix means every batch row masks against its own absolute positions
    (per-slot continuous batching). Causal; float32 accumulation.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    dv = v.shape[-1]
    sk = k.shape[1]
    c = min(kv_chunk, sk)
    pad = (-sk) % c
    k_pos = torch.atleast_2d(torch.as_tensor(k_pos, device=q.device)
                             ).expand(b, sk)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    n_chunks = (sk + pad) // c

    qh = q.reshape(b, sq, hkv, g, d).to(torch.float32) * (d ** -0.5)
    qp = torch.atleast_2d(torch.as_tensor(q_pos, device=q.device)
                          ).expand(b, sq)                   # (B, Sq)

    m = torch.full((b, hkv, g, sq), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * c:(j + 1) * c]                  # (B, c, Hkv, D)
        vj = v[:, j * c:(j + 1) * c]
        kpj = k_pos[:, j * c:(j + 1) * c]             # (B, c)
        dist = qp[:, :, None] - kpj[:, None, :]       # (B, Sq, c)
        mj = (kpj[:, None, :] >= 0) & (dist >= 0)     # causal
        if window:
            mj = mj & (dist < window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kj.to(torch.float32))
        s = torch.where(mj[:, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(torch.float32) if p_bf16 else p
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhv->bhgqv", pv, vj.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * dv)
    return out.to(v.dtype)


def _b(params, name):
    return {"b": params[name]} if name in params else {}


def apply(params, x: torch.Tensor, cfg: AttnConfig, quant: QuantConfig, *,
          cache=None, pos=None):
    """Returns (out, cache).

    Modes:
      prefill : x (B,S,D), pos None -> positions 0..S-1, or pos an offset
                (scalar or (B,)) for a suffix prefill over a cache that
                already holds the prefix; the cache is written if given.
      decode  : x (B,1,D) with integer ``pos`` — a scalar for uniform
                batch-synchronous decode, or a (B,) vector for per-slot
                positions (continuous batching: each row of the cache pool
                is at its own depth; writes and masks are per row).
    The cache is written in place at the queries' absolute positions;
    positions past each row's last written one are masked (k_pos = -1).
    """
    check_ported(cfg)
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = L.dense({"w": params["wq"], **_b(params, "bq")}, x, quant)
    k = L.dense({"w": params["wk"], **_b(params, "bk")}, x, quant)
    v = L.dense({"w": params["wv"], **_b(params, "bv")}, x, quant)
    q = q.reshape(b, s, cfg.n_heads, dh)
    k = k.reshape(b, s, cfg.n_kv_heads, dh)
    v = v.reshape(b, s, cfg.n_kv_heads, dh)

    q_pos = q_positions(pos, b, s, x.device)         # (B, s) absolute
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)

    if cache is None:
        out = _sdpa(q, k, v, q_pos, q_pos, cfg.window, p_bf16=cfg.p_bf16)
        return L.dense({"w": params["wo"]}, out, quant), None

    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    bidx = torch.arange(b, device=x.device)[:, None]
    slot_ids = torch.arange(slots, device=x.device)[None, :]
    ck[bidx, q_pos] = k.to(ck.dtype)
    cv[bidx, q_pos] = v.to(cv.dtype)
    written = q_pos[:, -1:] + 1                      # (B, 1)
    k_pos = torch.where(slot_ids < written, slot_ids, -1)
    out = _sdpa(q, ck, cv, q_pos, k_pos, cfg.window, p_bf16=cfg.p_bf16)
    return L.dense({"w": params["wo"]}, out, quant), cache

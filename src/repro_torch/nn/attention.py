"""Attention: grouped-query attention with RoPE (global causal or a
sliding window), cross-attention over encoder states (llama-3.2-vision)
and deepseek-v2's MLA, after the JAX package's ``repro.nn.attention``.

Cache conventions (per layer; stacked over the layers of a group by the
model):
  global attention : k/v (B, S_max, Hkv, Dh), written at each row's
                     absolute positions.
  windowed         : a ring buffer of W = min(window, S_max) slots; when
                     it holds the whole window, slot = pos % W and the
                     absolute position of each slot is rebuilt for the
                     masks. (With S_max < window the buffer is
                     position-indexed, and only the mask is windowed.)
  MLA              : the compressed c_kv (B, S_max, kv_lora) and k_pe
                     (B, S_max, rope_dim), position-indexed.
  cross            : none; K and V are projected from the encoder states
                     on every call, as in the reference.
``apply`` writes the cache in place (the JAX package returns an updated
copy) and returns it.

The attention math is plain PyTorch, as the JAX package leaves it to XLA
outside any Pallas kernel: blockwise online softmax in float32 over KV
chunks, masks rebuilt from absolute positions. It follows the reference's
order of operations rather than calling a fused library attention, so that
the two stacks' logits agree within a float32 bound. MLA runs the absorbed
formulation (scores in the compressed space); its ``wq`` / ``wdkv`` /
``wo`` projections go through the backend registry, its absorbed ``wuk`` /
``wuv`` products are float einsums, as in the reference.

A ring holds at most W positions, so a prefill longer than the ring
raises ``ValueError``: the reference's scatter of such a prompt writes one
slot twice in one update, and XLA defines no order for that.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import layers as L
from repro_torch.nn.module import ParamDesc, resolve_device
from repro_torch.quant.quantize import QuantConfig

NEG = -2.0 ** 30
KV_CHUNK = 1024


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
    D = cfg.d_model
    if cfg.is_mla:
        qd = cfg.n_heads * (cfg.qk_nope + cfg.qk_rope)
        return {
            "wq": ParamDesc((D, qd), ("embed", "heads"), dtype=dtype),
            "wdkv": ParamDesc((D, cfg.kv_lora + cfg.qk_rope),
                              ("embed", "kv_lora"), dtype=dtype),
            "wuk": ParamDesc((cfg.kv_lora, cfg.n_heads, cfg.qk_nope),
                             ("kv_lora", "heads", None), dtype=dtype),
            "wuv": ParamDesc((cfg.kv_lora, cfg.n_heads, cfg.v_head_dim),
                             ("kv_lora", "heads", None), dtype=dtype),
            "wo": ParamDesc((cfg.n_heads * cfg.v_head_dim, D),
                            ("heads", "embed"), dtype=dtype),
        }
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
               dtype=torch.bfloat16, device="cuda"):
    """One layer's zero cache on ``device`` (the card unless the caller
    asks for another): MLA's ckv / kpe (batch, max_len, kv_lora |
    rope_dim), or k / v (batch, slots, Hkv, Dh) with slots = max_len, or
    min(window, max_len) for a windowed layer."""
    device = resolve_device(device)
    if cfg.is_mla:
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora),
                                   dtype=dtype, device=device),
                "kpe": torch.zeros((batch, max_len, cfg.qk_rope),
                                   dtype=dtype, device=device)}
    slots = min(cfg.window, max_len) if cfg.window else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical(cfg: AttnConfig):
    """Logical axis names per ``init_cache`` leaf (the same keys, a tuple
    of names per leaf): batch rows over 'data', KV heads over 'model',
    positions replicated; MLA's compressed dim by 'kv_lora'."""
    if cfg.is_mla:
        return {"ckv": ("batch", None, "kv_lora"),
                "kpe": ("batch", None, None)}
    return {"k": ("batch", None, "kv_heads", None),
            "v": ("batch", None, "kv_heads", None)}


def is_ring(cfg: AttnConfig, slots: int) -> bool:
    """Whether a cache of ``slots`` positions is a ring buffer: a windowed
    layer whose buffer holds the whole window."""
    return bool(cfg.window) and slots == cfg.window


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, q_pos, k_pos, window: int, causal: bool = True,
          kv_chunk: int = KV_CHUNK, p_bf16: bool = False) -> torch.Tensor:
    """Blockwise (flash-style) attention: online softmax over KV chunks, so
    that no (Sq, Sk) score tensor over the whole cache is kept; chunk masks
    are rebuilt from absolute positions.

    q: (B,Sq,H,D) k/v: (B,Sk,Hkv,D[v]); q_pos (Sq,)/(B,Sq) and k_pos
    (Sk,)/(B,Sk) with -1 marking invalid slots — a full (B, S) position
    matrix means every batch row masks against its own absolute positions
    (per-slot continuous batching). Causal unless ``causal`` is False
    (cross-attention: only the invalid slots are masked); float32
    accumulation.
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
        mj = kpj[:, None, :] >= 0
        if causal:
            mj = mj & (dist >= 0)
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
          cache=None, pos=None, enc=None, qat: bool = False):
    """Returns (out, cache).

    Modes:
      prefill : x (B,S,D), pos None -> positions 0..S-1, or pos an offset
                (scalar or (B,)) for a suffix prefill over a cache that
                already holds the prefix; the cache is written if given.
      decode  : x (B,1,D) with integer ``pos`` — a scalar for uniform
                batch-synchronous decode, or a (B,) vector for per-slot
                positions (continuous batching: each row of the cache pool
                is at its own depth; writes and masks are per row).
      cross   : ``cfg.cross``; enc (B, Se, D), the projected encoder
                states, gives K and V through the quantized projections;
                no RoPE, every query at position 0 and the keys at
                0..Se-1, no causal mask (the last KV chunk's padding is
                masked); no cache: ``cache`` is returned as given.
    A position-indexed cache is written in place at the queries' absolute
    positions, and positions past each row's last written one are masked
    (k_pos = -1). A ring is written at slot = pos % W, and each slot's
    absolute position is rebuilt from the row's last query position.
    ``qat`` runs every projection as fake-quant (``layers.dense``).
    """
    if cfg.is_mla:
        return _apply_mla(params, x, cfg, quant, cache=cache, pos=pos,
                          qat=qat)
    b, s, _ = x.shape
    dh = cfg.head_dim
    kv_src = enc if cfg.cross else x
    q = L.dense({"w": params["wq"], **_b(params, "bq")}, x, quant, qat)
    k = L.dense({"w": params["wk"], **_b(params, "bk")}, kv_src, quant, qat)
    v = L.dense({"w": params["wv"], **_b(params, "bv")}, kv_src, quant, qat)
    q = q.reshape(b, s, cfg.n_heads, dh)
    k = k.reshape(b, kv_src.shape[1], cfg.n_kv_heads, dh)
    v = v.reshape(b, kv_src.shape[1], cfg.n_kv_heads, dh)

    if cfg.cross:
        enc_pos = torch.arange(kv_src.shape[1], device=x.device)[None, :]
        q_zero = torch.zeros((b, s), dtype=torch.int64, device=x.device)
        out = _sdpa(q, k, v, q_zero, enc_pos, 0, causal=False,
                    p_bf16=cfg.p_bf16)
        return L.dense({"w": params["wo"]}, out, quant, qat), cache

    q_pos = q_positions(pos, b, s, x.device)         # (B, s) absolute
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)

    if cache is None:
        out = _sdpa(q, k, v, q_pos, q_pos, cfg.window, p_bf16=cfg.p_bf16)
        return L.dense({"w": params["wo"]}, out, quant, qat), None

    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    bidx = torch.arange(b, device=x.device)[:, None]
    slot_ids = torch.arange(slots, device=x.device)[None, :]
    if is_ring(cfg, slots):
        _check_ring_write(q_pos, pos, slots)
        write_idx = q_pos % slots                    # (B, s)
        ck[bidx, write_idx] = k.to(ck.dtype)
        cv[bidx, write_idx] = v.to(cv.dtype)
        last = q_pos[:, -1:]                         # (B, 1)
        k_abs = last - ((last - slot_ids) % slots)   # abs pos held per slot
        k_pos = torch.where(k_abs >= 0, k_abs, -1)   # (B, slots)
    else:
        ck[bidx, q_pos] = k.to(ck.dtype)
        cv[bidx, q_pos] = v.to(cv.dtype)
        written = q_pos[:, -1:] + 1                  # (B, 1)
        k_pos = torch.where(slot_ids < written, slot_ids, -1)
    out = _sdpa(q, ck, cv, q_pos, k_pos, cfg.window, p_bf16=cfg.p_bf16)
    return L.dense({"w": params["wo"]}, out, quant, qat), cache


def _check_ring_write(q_pos, pos, slots: int) -> None:
    """Refuse a multi-token write that a ring of ``slots`` cannot hold.

    After the write each slot holds the latest of the positions that map
    to it, so the keys a query needs, (q - W, q], are all there only for a
    single query (decode) or for queries that never wrap (every position
    below W, as in a prefill from position 0 of at most W tokens). The
    reference scatters a longer prompt into the ring with repeated slot
    indices in one update, an order XLA does not define, and its earlier
    queries then find their keys overwritten: no result can be held to
    that, so the port raises instead."""
    s = q_pos.shape[1]
    if s == 1:
        return
    last = s - 1 if pos is None else int(q_pos[:, -1].max())
    if last >= slots:
        raise ValueError(
            f"a windowed ring buffer of {slots} slots cannot take {s} "
            f"tokens reaching position {last}: positions {slots} apart "
            "share a slot, so the earlier queries of the write would lose "
            "their keys (prefill at most the window, then decode)")


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): the absorbed formulation
# ---------------------------------------------------------------------------

def _apply_mla(params, x: torch.Tensor, cfg: AttnConfig, quant: QuantConfig,
               *, cache, pos, qat: bool):
    """Scores q_nope^T (Wuk^T c_kv) evaluated as (q_nope Wuk) . c_kv, and
    the context taken in the compressed space before ``wuv``: no
    (B, S, H, Dh) key or value is ever expanded. Online softmax over KV
    chunks, as ``_sdpa``. The cache, when given, is written in place at
    the queries' absolute positions."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope, cfg.qk_rope
    f32 = torch.float32
    q = L.dense({"w": params["wq"]}, x, quant, qat).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    dkv = L.dense({"w": params["wdkv"]}, x, quant, qat)
    ckv_new, kpe_new = dkv[..., :cfg.kv_lora], dkv[..., cfg.kv_lora:]

    q_pos = q_positions(pos, b, s, x.device)         # (B, s) absolute
    q_pe = rope(q_pe, q_pos, cfg.rope_theta)
    kpe_new = rope(kpe_new[:, :, None, :], q_pos, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        ckv, kpe = cache["ckv"], cache["kpe"]
        bidx = torch.arange(b, device=x.device)[:, None]
        ckv[bidx, q_pos] = ckv_new.to(ckv.dtype)
        kpe[bidx, q_pos] = kpe_new.to(kpe.dtype)
        written = q_pos[:, -1:] + 1                  # (B, 1)
        slot_ids = torch.arange(ckv.shape[1], device=x.device)[None, :]
        k_pos = torch.where(slot_ids < written, slot_ids, -1)
    else:
        ckv, kpe = ckv_new, kpe_new
        k_pos = q_pos

    scale = (dn + dr) ** -0.5
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.to(f32),
                         params["wuk"].to(f32)) * scale
    q_pe32 = q_pe.to(f32) * scale
    sk = ckv.shape[1]
    c = min(KV_CHUNK, sk)
    pad = (-sk) % c
    kpos = k_pos.expand(b, sk)
    if pad:
        ckv = torch.nn.functional.pad(ckv, (0, 0, 0, pad))
        kpe = torch.nn.functional.pad(kpe, (0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    lora = ckv.shape[-1]
    m = torch.full((b, h, s), NEG, dtype=f32, device=x.device)
    l = torch.zeros((b, h, s), dtype=f32, device=x.device)
    acc = torch.zeros((b, h, s, lora), dtype=f32, device=x.device)
    for j in range(0, sk + pad, c):
        ckv_j = ckv[:, j:j + c].to(f32)
        kpj = kpos[:, j:j + c]                       # (B, c)
        dist = q_pos[:, :, None] - kpj[:, None, :]   # (B, s, c)
        mj = (kpj[:, None, :] >= 0) & (dist >= 0)
        sc = (torch.einsum("bshl,bkl->bhsk", q_abs, ckv_j)
              + torch.einsum("bshr,bkr->bhsk", q_pe32,
                             kpe[:, j:j + c].to(f32)))
        sc = torch.where(mj[:, None], sc, NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(f32) if cfg.p_bf16 else p
        acc = acc * corr[..., None] + torch.einsum("bhsk,bkl->bhsl", pv,
                                                   ckv_j)
        m = m_new
    ctx = (acc / torch.clamp_min(l[..., None], 1e-30)).permute(0, 2, 1, 3)
    out = torch.einsum("bshl,lhv->bshv", ctx.to(x.dtype).to(f32),
                       params["wuv"].to(f32)).to(x.dtype)
    out = out.reshape(b, s, h * cfg.v_head_dim)
    return L.dense({"w": params["wo"]}, out, quant, qat), cache

"""The decoder LM of the JAX package's ``repro.models.transformer_lm``, for
the dense global-attention families (smollm, qwen1.5, deepseek-coder).

A config compiles to a "block program": a list of (repeat, [layer kinds])
groups. Each group's params are stacked on a leading ``repeat`` axis, in
the reference's layout, so that weights carry across by a tree map
(``repro_torch.convert``). Where the reference scans over the stacked axis,
``backbone`` runs a Python loop over it; caches mirror the block program
and are indexed the same way, and are written in place.

Every projection (QKV, attention output, MLP, the LM head) runs through
``quantized_matmul``, and so through the backend registry: the approximate
multiplier's CUDA kernels on the card, under the ``*_pallas`` backends.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): windowed, cross and MLA attention, MoE, the SSM layers (rwkv6,
hymba), stub embeddings and multi-codebook heads (musicgen), and the
speculative ``verify_step`` / ``rollback_positions``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn.module import (ParamDesc, init_params, resolve_device,
                                   stack)
from repro_torch.quant.quantize import BF16, QuantConfig

NOT_PORTED = {
    "moe": "mixture-of-experts layers (deepseek-v2, kimi-k2) are not "
           "ported yet: ROADMAP.md queue A, item 17",
    "ssm": "SSM layers (rwkv6, hymba) are not ported yet: ROADMAP.md "
           "queue A, item 18",
    "io": "stub embeddings and multi-codebook heads (musicgen) are not "
          "ported yet: ROADMAP.md queue A, item 19",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_act: str = "swiglu"          # swiglu|geglu|gelu
    # layer pattern
    local_window: int = 0
    local_ratio: int = 0             # N local layers per 1 global (gemma3: 5)
    cross_every: int = 0             # 1 cross-attn layer per N (llama-vision)
    enc_dim: int = 0
    enc_len: int = 0
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    moe_int8_gather: bool = False
    moe_capacity: float = 1.25
    attn_p_bf16: bool = False        # bf16 softmax weights for the PV dot
    # mla
    kv_lora: int = 0
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # ssm
    ssm: str = ""                    # ''|rwkv6|hymba
    ssm_state: int = 16
    rwkv_chunked: bool = False
    # io
    embed_stub: bool = False
    n_codebooks: int = 1
    tied_embeddings: bool = True
    # numerics
    param_dtype: Any = torch.float32
    quant: QuantConfig = BF16
    vocab_pad: int = 0               # padded vocab (0 -> no padding)
    remat: bool = True
    sub_quadratic: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return self.vocab_pad or self.vocab

    def attn_cfg(self) -> A.AttnConfig:
        """Every layer's attention; the windowed, cross and MLA fields are
        passed on so that ``A.check_ported`` refuses them."""
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.dh,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            window=self.local_window, cross=bool(self.cross_every),
            p_bf16=self.attn_p_bf16,
            kv_lora=self.kv_lora, qk_nope=self.qk_nope if self.kv_lora else 0,
            qk_rope=self.qk_rope if self.kv_lora else 0,
            v_head_dim=self.v_head_dim if self.kv_lora else 0)

    # ---- block program ----
    def blocks(self) -> List[Tuple[int, Tuple[str, ...]]]:
        """One group of ``n_layers`` global self-attention layers: the
        program of every family this port runs."""
        return [(self.n_layers, ("self",))]


def check_ported(cfg: ArchConfig) -> None:
    """Raise for every part of ``cfg`` this port does not run yet."""
    if cfg.ssm:
        raise NotImplementedError(NOT_PORTED["ssm"])
    if cfg.n_experts:
        raise NotImplementedError(NOT_PORTED["moe"])
    if cfg.embed_stub or cfg.n_codebooks > 1:
        raise NotImplementedError(NOT_PORTED["io"])
    if cfg.local_ratio:
        raise NotImplementedError(A.NOT_PORTED["window"])
    A.check_ported(cfg.attn_cfg())


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

def _mlp_desc(cfg: ArchConfig, dtype):
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"wg": ParamDesc((D, Fd), ("fsdp", "mlp"), dtype=dtype),
                "wu": ParamDesc((D, Fd), ("fsdp", "mlp"), dtype=dtype),
                "wd": ParamDesc((Fd, D), ("mlp", "fsdp"), dtype=dtype)}
    return {"wu": ParamDesc((D, Fd), ("fsdp", "mlp"), dtype=dtype),
            "wd": ParamDesc((Fd, D), ("mlp", "fsdp"), dtype=dtype)}


def _layer_desc(cfg: ArchConfig, dtype):
    return {"ln1": L.rmsnorm_desc(cfg.d_model, dtype),
            "ln2": L.rmsnorm_desc(cfg.d_model, dtype),
            "attn": A.attn_desc(cfg.attn_cfg(), dtype),
            "mlp": _mlp_desc(cfg, dtype)}


def descs(cfg: ArchConfig):
    check_ported(cfg)
    dtype = cfg.param_dtype
    tree: Dict[str, Any] = {
        "embed": L.embed_desc(cfg.padded_vocab, cfg.d_model, dtype)}
    if not cfg.tied_embeddings:
        tree["lm_head"] = L.embed_desc(cfg.padded_vocab, cfg.d_model, dtype)
    tree["final_ln"] = L.rmsnorm_desc(cfg.d_model, dtype)
    tree["blocks"] = []
    for rep, kinds in cfg.blocks():
        group = {f"k{i}_{kind}": _layer_desc(cfg, dtype)
                 for i, kind in enumerate(kinds)}
        tree["blocks"].append(stack(group, rep))
    return tree


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator`` (the JAX package's scales; the
    numbers differ, since its RNG is another)."""
    return init_params(descs(cfg), generator, device)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Cache tree mirroring the block program (stacked per group): every
    leaf is (repeat, batch, max_len, Hkv, Dh), zero."""
    check_ported(cfg)
    dev = resolve_device(device)
    blocks = []
    for rep, kinds in cfg.blocks():
        group = {f"k{i}_{kind}": A.init_cache(cfg.attn_cfg(), batch,
                                              max_len, dtype, dev)
                 for i, kind in enumerate(kinds)}
        blocks.append(map_leaves(lambda t: t.expand(rep, *t.shape).clone(),
                                 group))
    return {"blocks": blocks}


def map_leaves(fn, *trees):
    """``fn`` over the tensor leaves of same-shaped trees of dicts and
    lists."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_leaves(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [map_leaves(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mlp(params, x, cfg: ArchConfig):
    q = cfg.quant
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = L.dense({"w": params["wg"]}, x, q)
        u = L.dense({"w": params["wu"]}, x, q)
        act = F.silu(g) if cfg.mlp_act == "swiglu" else L.gelu(g)
        h = act * u
    else:
        h = L.gelu(L.dense({"w": params["wu"]}, x, q))
    return L.dense({"w": params["wd"]}, h, q)


def _layer(params, x, cfg: ArchConfig, *, cache, pos):
    h = L.rmsnorm(params["ln1"], x)
    ao, new_cache = A.apply(params["attn"], h, cfg.attn_cfg(), cfg.quant,
                            cache=cache, pos=pos)
    x = x + ao
    h2 = L.rmsnorm(params["ln2"], x)
    x = x + _mlp(params["mlp"], h2, cfg)
    return x, new_cache


def backbone(params, x, cfg: ArchConfig, *, caches=None, pos=None):
    """x: (B,S,D) embeddings -> (hidden, caches). A Python loop over each
    group's stacked layers; the caches are written in place."""
    check_ported(cfg)
    for bi, (rep, kinds) in enumerate(cfg.blocks()):
        bparams = params["blocks"][bi]
        bcache = None if caches is None else caches["blocks"][bi]
        for r in range(rep):
            lp = map_leaves(lambda t: t[r], bparams)
            for i, kind in enumerate(kinds):
                key = f"k{i}_{kind}"
                c = (None if bcache is None else
                     {n: t[r] for n, t in bcache[key].items()})
                x, _ = _layer(lp[key], x, cfg, cache=c, pos=pos)
    return L.rmsnorm(params["final_ln"], x), caches


def embed_tokens(params, tokens, cfg: ArchConfig):
    x = L.embed(params["embed"], tokens)
    return x.to(torch.bfloat16) if cfg.param_dtype == torch.bfloat16 else x


def lm_logits(params, hidden, cfg: ArchConfig):
    """Final projection to the vocab, through the backend registry for a
    quantized config (the widest matmul of the stack)."""
    table = (params["lm_head"]["table"] if "lm_head" in params
             else params["embed"]["table"])
    return L.logits({"table": table}, hidden, true_vocab=cfg.vocab,
                    quant=cfg.quant)


def forward_loss(params, batch, cfg: ArchConfig):
    """batch: {tokens, labels} -> scalar mean cross-entropy."""
    x = embed_tokens(params, batch["tokens"], cfg)
    h, _ = backbone(params, x, cfg)
    lg = lm_logits(params, h, cfg)
    return L.softmax_cross_entropy(lg, batch["labels"], cfg.vocab)


def prefill(params, tokens, cfg: ArchConfig, caches, lengths=None,
            pos_offset=None):
    """Batched prefill -> (next-token logits (B, 1, V), caches).

    lengths: optional (B,) true prompt lengths for a right-padded batch —
    logits are gathered at each row's last real token (the padded tail's
    KV is masked out of later decode steps by absolute position).

    pos_offset: optional scalar (or (B,)) absolute position of
    ``tokens[:, 0]`` — a suffix prefill over a cache already holding KV for
    positions [0, pos_offset); the serving engine's prefix-cache hit. None
    (or 0) is a cold prefill from position 0.
    """
    x = embed_tokens(params, tokens, cfg)
    h, caches = backbone(params, x, cfg, caches=caches, pos=pos_offset)
    if lengths is not None:
        idx = torch.as_tensor(lengths, dtype=torch.int64,
                              device=h.device) - 1
        h = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
    else:
        h = h[:, -1:]
    return lm_logits(params, h, cfg), caches


def decode_step(params, token, pos, cfg: ArchConfig, caches):
    """token: (B,1) ids; pos: a scalar for uniform batch-synchronous
    decode, or a (B,) vector giving each cache row its own absolute
    position (per-slot continuous batching)."""
    x = embed_tokens(params, token, cfg)
    h, caches = backbone(params, x, cfg, caches=caches, pos=pos)
    return lm_logits(params, h, cfg), caches


# ---------------------------------------------------------------------------
# Paged cache indirection (the serving engine's page store)
# ---------------------------------------------------------------------------
#
# A page store is an init_cache tree with (batch -> n_pages, max_len ->
# page_size): every leaf becomes (rep, n_pages, page_size, ...). Gather and
# store move whole pages between the store and a cache row by page index.

def init_page_store(cfg: ArchConfig, n_pages: int, page_size: int,
                    dtype=torch.bfloat16, device="cuda"):
    """KV page store: ``n_pages`` pages of ``page_size`` positions each."""
    return init_cache(cfg, n_pages, page_size, dtype, device)


def gather_pages(cache, pages, page_ids):
    """Copy a page chain into positions [0, n * page_size) of a batch-1
    cache (the copy-on-write copy: shared pages are read, never written).
    Writes ``cache`` in place and returns it."""
    def leaf(row, pg):
        ids = torch.as_tensor(page_ids, dtype=torch.int64, device=pg.device)
        sel = pg[:, ids]                               # (rep, n, ps, ...)
        sel = sel.reshape(sel.shape[0], 1, sel.shape[1] * sel.shape[2],
                          *sel.shape[3:])
        row[:, :, :sel.shape[2]] = sel.to(row.dtype)
        return row

    return map_leaves(leaf, cache, pages)


def store_pages(pages, pool, slot: int, page_ids, page_indices):
    """Freeze pages out of one slot row of a serving pool: positions
    [page_indices[i] * ps, (page_indices[i] + 1) * ps) of ``pool[:, slot]``
    go into page ``page_ids[i]``. Writes ``pages`` in place and returns
    it."""
    def leaf(pg, pl):
        ids = torch.as_tensor(page_ids, dtype=torch.int64, device=pg.device)
        idxs = torch.as_tensor(page_indices, dtype=torch.int64,
                               device=pg.device)
        ps = pg.shape[2]
        row = pl[:, slot]                              # (rep, max_len, ...)
        n_pos = row.shape[1] // ps
        segs = row[:, :n_pos * ps].reshape(row.shape[0], n_pos, ps,
                                           *row.shape[2:])
        pg[:, ids] = segs[:, idxs].to(pg.dtype)
        return pg

    return map_leaves(leaf, pages, pool)

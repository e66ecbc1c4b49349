"""The decoder LM of the JAX package's ``repro.models.transformer_lm``, for
the dense global-attention families (smollm, qwen1.5, deepseek-coder),
gemma3's 5:1 local:global sliding window, the mixture-of-experts families
with GQA (kimi-k2) or MLA (deepseek-v2) attention, the attention-free
RWKV6 and hymba's hybrid of windowed attention and Mamba.

A config compiles to a "block program": a list of (repeat, [layer kinds])
groups:

  dense / moe :  [(L, ('self',))]
  gemma3 5:1  :  [(L // 6, ('local',) * 5 + ('global',)),
                  (1, ('global',) * (L % 6))]
  rwkv6       :  [(L, ('rwkv',))]
  hymba       :  [(L, ('hymba',))]

Each group's params are stacked on a leading ``repeat`` axis, in the
reference's layout, so that weights carry across by a tree map
(``repro_torch.convert``). Where the reference scans over the stacked axis,
``backbone`` runs a Python loop over it; caches mirror the block program
and are indexed the same way, and are written in place. An SSM layer's
cache is its recurrent state (``nn/ssm.py``), float32 whatever the cache
dtype: RWKV6's WKV state and the two token-shift rows, hymba's Mamba state
and conv rows beside its attention ring.

Every projection (QKV, attention output, MLP, the SSM mixers', the LM head)
runs through ``quantized_matmul``, and so through the backend registry:
the approximate multiplier's CUDA kernels on the card, under the
``*_pallas`` backends.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): cross-attention (llama-3.2 vision), stub embeddings and
multi-codebook heads (musicgen).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as MOE
from repro_torch.nn import ssm as SSM
from repro_torch.nn.module import (ParamDesc, init_params, resolve_device,
                                   stack)
from repro_torch.quant.quantize import BF16, QuantConfig

NOT_PORTED = {
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

    def attn_cfg(self, kind: str = "self") -> A.AttnConfig:
        """The attention of a layer of ``kind`` ('self', 'local',
        'global', hymba's windowed 'hymba_attn'; 'cross' is passed on so
        that ``A.check_ported`` refuses it)."""
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.dh,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            window=(self.local_window if kind in ("local", "hymba_attn")
                    else 0),
            cross=(kind == "cross"), p_bf16=self.attn_p_bf16,
            kv_lora=self.kv_lora, qk_nope=self.qk_nope if self.kv_lora else 0,
            qk_rope=self.qk_rope if self.kv_lora else 0,
            v_head_dim=self.v_head_dim if self.kv_lora else 0)

    def moe_cfg(self) -> MOE.MoEConfig:
        return MOE.MoEConfig(d_model=self.d_model, n_experts=self.n_experts,
                             top_k=self.top_k, d_ff=self.moe_d_ff or self.d_ff,
                             n_shared=self.n_shared,
                             int8_gather=self.moe_int8_gather,
                             capacity_factor=self.moe_capacity)

    def rwkv_cfg(self) -> SSM.RWKVConfig:
        """RWKV6's head_dim is d_model // n_heads, not ``dh``."""
        return SSM.RWKVConfig(d_model=self.d_model, n_heads=self.n_heads)

    def mamba_cfg(self) -> SSM.MambaConfig:
        """d_inner = d_model, as in the reference."""
        return SSM.MambaConfig(d_model=self.d_model, d_inner=self.d_model,
                               n_state=self.ssm_state)

    # ---- block program ----
    def blocks(self) -> List[Tuple[int, Tuple[str, ...]]]:
        Lc = self.n_layers
        if self.ssm == "rwkv6":
            return [(Lc, ("rwkv",))]
        if self.ssm == "hymba":
            return [(Lc, ("hymba",))]
        if self.local_ratio:
            per = self.local_ratio + 1
            n_groups, rem = divmod(Lc, per)
            prog = [(n_groups, ("local",) * self.local_ratio + ("global",))]
            if rem:
                prog.append((1, ("global",) * rem))
            return prog
        if self.cross_every:
            per = self.cross_every
            n_groups, rem = divmod(Lc, per)
            prog = [(n_groups, ("self",) * (per - 1) + ("cross",))]
            if rem:
                prog.append((1, ("self",) * rem))
            return prog
        return [(Lc, ("self",))]


def check_ported(cfg: ArchConfig) -> None:
    """Raise for every part of ``cfg`` this port does not run yet."""
    if cfg.embed_stub or cfg.n_codebooks > 1:
        raise NotImplementedError(NOT_PORTED["io"])
    for _, kinds in cfg.blocks():
        for kind in kinds:
            A.check_ported(cfg.attn_cfg(kind))


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


def _layer_desc(cfg: ArchConfig, kind: str, dtype):
    d: Dict[str, Any] = {"ln1": L.rmsnorm_desc(cfg.d_model, dtype),
                         "ln2": L.rmsnorm_desc(cfg.d_model, dtype)}
    if kind == "rwkv":
        d["tmix"] = SSM.rwkv_tmix_desc(cfg.rwkv_cfg(), dtype)
        d["cmix"] = SSM.rwkv_cmix_desc(cfg.d_model, cfg.d_ff, dtype)
        return d
    if kind == "hymba":
        d["attn"] = A.attn_desc(cfg.attn_cfg("hymba_attn"), dtype)
        d["mamba"] = SSM.mamba_desc(cfg.mamba_cfg(), dtype)
        d["mlp"] = _mlp_desc(cfg, dtype)
        return d
    d["attn"] = A.attn_desc(cfg.attn_cfg(kind), dtype)
    if cfg.n_experts:
        d["moe"] = MOE.moe_desc(cfg.moe_cfg(), dtype)
    else:
        d["mlp"] = _mlp_desc(cfg, dtype)
    return d


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
        group = {f"k{i}_{kind}": _layer_desc(cfg, kind, dtype)
                 for i, kind in enumerate(kinds)}
        tree["blocks"].append(stack(group, rep))
    return tree


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator`` (the JAX package's scales; the
    numbers differ, since its RNG is another; on the card the largest
    leaves come from the card's generator, ``nn.module.init_params``)."""
    return init_params(descs(cfg), generator, device)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Cache tree mirroring the block program (stacked per group), zero:
    k/v leaves (repeat, batch, slots, Hkv, Dh), with slots = max_len for
    global layers and min(window, max_len) for local ones; MLA's ckv / kpe
    leaves (repeat, batch, max_len, kv_lora | rope_dim); an SSM layer's
    state (``_kind_cache``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    blocks = []
    for rep, kinds in cfg.blocks():
        group = {f"k{i}_{kind}": _kind_cache(cfg, kind, batch, max_len,
                                             dtype, dev)
                 for i, kind in enumerate(kinds)}
        blocks.append(map_leaves(lambda t: t.expand(rep, *t.shape).clone(),
                                 group))
    return {"blocks": blocks}


def _kind_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                dtype, dev):
    """One layer's cache. An SSM state has no positions and is float32
    whatever ``dtype``: RWKV6's WKV state S (batch, H, N, N) with its two
    token-shift rows xprev / cm_xprev (batch, D); hymba's attention cache
    (a ring of min(window, max_len) slots) beside Mamba's state h
    (batch, d_inner, n_state) and its last conv inputs (batch, conv_k - 1,
    d_inner)."""
    f32 = dict(dtype=torch.float32, device=dev)
    if kind == "rwkv":
        H, N = cfg.n_heads, cfg.rwkv_cfg().head_dim
        return {"S": torch.zeros((batch, H, N, N), **f32),
                "xprev": torch.zeros((batch, cfg.d_model), **f32),
                "cm_xprev": torch.zeros((batch, cfg.d_model), **f32)}
    if kind == "hymba":
        mc = cfg.mamba_cfg()
        return {"attn": A.init_cache(cfg.attn_cfg("hymba_attn"), batch,
                                     max_len, dtype, dev),
                "h": torch.zeros((batch, mc.d_inner, mc.n_state), **f32),
                "conv": torch.zeros((batch, mc.conv_k - 1, mc.d_inner),
                                    **f32)}
    return A.init_cache(cfg.attn_cfg(kind), batch, max_len, dtype, dev)


def map_leaves(fn, *trees):
    """``fn`` over the tensor leaves of same-shaped trees of dicts and
    lists."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_leaves(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [map_leaves(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def write_slot(pool, one, slot: int):
    """Full-row copy of a freshly prefilled batch-1 cache ``one`` into row
    ``slot`` of the cache pool, in place; returns the pool. Every leaf is
    copied whole, an SSM state too: a parked slot folds junk into its
    state at every decode step, and admission overwrites all of it."""
    def leaf(p, o):
        p[:, slot] = o[:, 0]
        return p
    return map_leaves(leaf, pool, one)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mlp(params, x, cfg: ArchConfig, qat: bool):
    q = cfg.quant
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = L.dense({"w": params["wg"]}, x, q, qat)
        u = L.dense({"w": params["wu"]}, x, q, qat)
        act = F.silu(g) if cfg.mlp_act == "swiglu" else L.gelu(g)
        h = act * u
    else:
        h = L.gelu(L.dense({"w": params["wu"]}, x, q, qat))
    return L.dense({"w": params["wd"]}, h, q, qat)


def _rmsnorm_columns(params, x):
    """``rmsnorm`` of each sequence column alone: the (B, 1, D) shape, and
    so the reduction order, of a decode step."""
    return torch.cat([L.rmsnorm(params, x[:, j:j + 1])
                      for j in range(x.shape[1])], dim=1)


def _layer(params, x, kind: str, cfg: ArchConfig, *, cache, pos, qat,
           columns=False):
    """One layer -> (x, aux). ``columns`` is :func:`verify_step`'s: the
    norms, MLA attention and a mixture-of-experts layer run once per
    sequence column."""
    if kind == "rwkv":
        return _rwkv_layer(params, x, cfg, cache=cache, qat=qat)
    if kind == "hymba":
        return _hymba_layer(params, x, cfg, cache=cache, pos=pos, qat=qat)
    norm = _rmsnorm_columns if columns else L.rmsnorm
    h = norm(params["ln1"], x)
    acfg = cfg.attn_cfg(kind)
    if columns and acfg.is_mla:
        ao = torch.cat([A.apply(params["attn"], _column(h, j), acfg,
                                cfg.quant, cache=cache, pos=pos + j,
                                qat=qat)[0] for j in range(h.shape[1])],
                       dim=1)
    else:
        ao, _ = A.apply(params["attn"], h, acfg, cfg.quant, cache=cache,
                        pos=pos, qat=qat)
    x = x + ao
    h2 = norm(params["ln2"], x)
    if "moe" not in params:
        return x + _mlp(params["mlp"], h2, cfg, qat), _zero(x)
    mcfg = cfg.moe_cfg()
    if not columns:
        mo, aux = MOE.apply(params["moe"], h2, mcfg, cfg.quant, qat=qat)
        return x + mo, aux
    outs = [MOE.apply(params["moe"], _column(h2, j), mcfg, cfg.quant,
                      qat=qat) for j in range(h2.shape[1])]
    return (x + torch.cat([o for o, _ in outs], dim=1),
            sum(a for _, a in outs))


def _store(cache, **state) -> None:
    """Write an SSM layer's new state into its cache leaves, in place."""
    for name, t in state.items():
        cache[name].copy_(t)


def _rwkv_layer(params, x, cfg: ArchConfig, *, cache, qat):
    """Time mix, then channel mix, each behind its RMS norm and residual;
    the WKV state and both token-shift rows carried in ``cache``."""
    h = L.rmsnorm(params["ln1"], x)
    st = None if cache is None else {"S": cache["S"],
                                     "xprev": cache["xprev"]}
    mix, new = SSM.rwkv_tmix(params["tmix"], h, cfg.rwkv_cfg(), cfg.quant,
                             state=st, qat=qat, chunked=cfg.rwkv_chunked)
    x = x + mix
    h2 = L.rmsnorm(params["ln2"], x)
    ff, cm_x = SSM.rwkv_cmix(params["cmix"], h2, cfg.quant,
                             xprev=None if cache is None
                             else cache["cm_xprev"], qat=qat)
    if cache is not None:
        _store(cache, S=new["S"], xprev=new["xprev"], cm_xprev=cm_x)
    return x + ff, _zero(x)


def _hymba_layer(params, x, cfg: ArchConfig, *, cache, pos, qat):
    """Windowed attention and Mamba side by side on the same normed input,
    averaged into the residual, then the MLP."""
    h = L.rmsnorm(params["ln1"], x)
    ao, _ = A.apply(params["attn"], h, cfg.attn_cfg("hymba_attn"),
                    cfg.quant, cache=None if cache is None else cache["attn"],
                    pos=pos, qat=qat)
    st = None if cache is None else {"h": cache["h"], "conv": cache["conv"]}
    so, new = SSM.mamba(params["mamba"], h, cfg.mamba_cfg(), cfg.quant,
                        state=st, qat=qat)
    if cache is not None:
        _store(cache, **new)
    x = x + 0.5 * (ao + so)                      # parallel heads fusion
    h2 = L.rmsnorm(params["ln2"], x)
    return x + _mlp(params["mlp"], h2, cfg, qat), _zero(x)


def _column(x, j: int):
    """Column j of (B, S, D) as a contiguous (B, 1, D) tensor: the layout,
    and so the float kernels, of a decode step's input."""
    return x[:, j:j + 1].contiguous()


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def backbone(params, x, cfg: ArchConfig, *, caches=None, pos=None,
             qat: bool = False, training: bool = False,
             columns: bool = False):
    """x: (B,S,D) embeddings -> (hidden, caches, aux). A Python loop over
    each group's stacked layers; the caches are written in place; ``aux``
    sums the mixture-of-experts layers' load-balancing losses (0 without
    them). ``qat`` runs every projection as fake-quant; ``training`` with
    ``cfg.remat`` recomputes each layer in the backward instead of keeping
    its activations (the reference's ``jax.checkpoint``). ``columns`` is
    :func:`verify_step`'s: the norms, MLA attention and the experts run
    per column."""
    check_ported(cfg)
    remat = cfg.remat and training and caches is None
    aux = _zero(x)
    for bi, (rep, kinds) in enumerate(cfg.blocks()):
        bparams = params["blocks"][bi]
        bcache = None if caches is None else caches["blocks"][bi]
        for r in range(rep):
            lp = map_leaves(lambda t: t[r], bparams)
            for i, kind in enumerate(kinds):
                key = f"k{i}_{kind}"
                c = (None if bcache is None else
                     map_leaves(lambda t: t[r], bcache[key]))
                fn = functools.partial(_layer, kind=kind, cfg=cfg, cache=c,
                                       pos=pos, qat=qat, columns=columns)
                x, a = (checkpoint(fn, lp[key], x, use_reentrant=False)
                        if remat else fn(lp[key], x))
                aux = aux + a
    norm = _rmsnorm_columns if columns else L.rmsnorm
    return norm(params["final_ln"], x), caches, aux


def embed_tokens(params, tokens, cfg: ArchConfig):
    x = L.embed(params["embed"], tokens)
    return x.to(torch.bfloat16) if cfg.param_dtype == torch.bfloat16 else x


def lm_logits(params, hidden, cfg: ArchConfig, *, qat: bool = False):
    """Final projection to the vocab, through the backend registry for a
    quantized config (the widest matmul of the stack); under ``qat`` a
    float matmul over the fake-quantized table (``layers.logits``)."""
    table = (params["lm_head"]["table"] if "lm_head" in params
             else params["embed"]["table"])
    return L.logits({"table": table}, hidden, true_vocab=cfg.vocab,
                    quant=cfg.quant, qat=qat)


def forward_loss(params, batch, cfg: ArchConfig, *, qat: bool = False,
                 training: bool = True):
    """batch: {tokens, labels} -> scalar mean cross-entropy, plus the
    mixture-of-experts layers' load-balancing loss."""
    x = embed_tokens(params, batch["tokens"], cfg)
    h, _, aux = backbone(params, x, cfg, qat=qat, training=training)
    lg = lm_logits(params, h, cfg, qat=qat)
    return L.softmax_cross_entropy(lg, batch["labels"], cfg.vocab) + aux


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

    A windowed layer's ring takes a prefill of at most its window
    (``nn.attention`` raises ``ValueError`` past it). A mixture-of-experts
    layer routes each row of the call as one group, so its capacity, and
    with it which entries it drops, depends on the call's tokens (padding
    included), as in the reference.
    """
    x = embed_tokens(params, tokens, cfg)
    h, caches, _ = backbone(params, x, cfg, caches=caches, pos=pos_offset)
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
    h, caches, _ = backbone(params, x, cfg, caches=caches, pos=pos)
    return lm_logits(params, h, cfg), caches


def position_indexed(cfg: ArchConfig) -> bool:
    """Whether every cache leaf of ``cfg`` is indexed by absolute position
    (global GQA and MLA; not windowed rings or SSM states): what prompt
    padding, paging and rollback need. The predicate of the reference's
    ``serve.padded_prefill_ok``."""
    return cfg.ssm == "" and cfg.local_ratio == 0 and cfg.local_window == 0


WINDOWED = {"local": "local", "hymba": "hymba_attn"}   # kind -> attention


def prefill_limit(cfg: ArchConfig, max_len: int):
    """The longest prefill a cache of ``max_len`` positions takes: the
    window, where a windowed layer's ring (gemma3's local layers, hymba's
    attention) holds the whole window (``nn.attention`` refuses a longer
    write); None where only ``max_len`` bounds it."""
    for _, kinds in cfg.blocks():
        for kind in kinds:
            if kind in WINDOWED:
                acfg = cfg.attn_cfg(WINDOWED[kind])
                if A.is_ring(acfg, min(acfg.window, max_len)):
                    return acfg.window
    return None


def require_position_indexed(cfg: ArchConfig) -> None:
    """Refuse speculation (verify and rollback) over ``cfg``'s caches."""
    if not position_indexed(cfg):
        raise ValueError(
            "speculative decoding requires position-indexed caches: SSM "
            "states and windowed ring buffers cannot roll back rejected "
            f"positions ({cfg.name})")


def verify_step(params, window, pos, cfg: ArchConfig, caches):
    """One speculative verify pass: a (B, K) token window per cache row.

    ``window[b]`` holds the row's committed next-input token followed by
    K-1 draft proposals; ``pos`` is the (B,) position of ``window[:, 0]``,
    so row b's tokens sit at absolute positions ``pos[b] + [0, K)``. Logits
    row j is the model's next-token distribution after consuming
    ``window[:, :j+1]``. KV for all K window positions is written to the
    cache in place; the caller erases positions past the accepted frontier
    with :func:`rollback_positions` before the next step.

    This is :func:`decode_step` at width K, with one difference: the RMS
    norms run once per window column, each on the (B, 1, D) shape of a
    decode step. On the card ``torch.mean``'s launch configuration, and
    with it its summation order, depends on its output count, so a norm
    over the whole window rounds differently from the K sequential steps.
    The projections and the attention stay at width K: the int8 codes and
    integer sums are row-local and exact, the dequantization elementwise,
    and the attention's masked window positions weigh exactly 0. So for
    every integer backend, row j equals the j-th sequential
    :func:`decode_step`'s logits bit for bit, and the cache writes equal
    its writes; under ``bf16`` the float projections are not row-local, and
    only the tokens are claimed.

    MLA attention and a mixture-of-experts layer run once per column too,
    each column a decode step's (B, 1) call at its own position: MLA's
    absorbed float einsums round another way at width K on the card, and
    a mixture-of-experts layer sets its capacity per call group
    (``nn.moe``), so a K-token group would drop entries that K one-token
    decode steps keep. (The reference's verify pass runs both at width K;
    for these archs the port's verify rows are those of sequential decode
    instead.)"""
    require_position_indexed(cfg)
    x = embed_tokens(params, window, cfg)
    h, caches, _ = backbone(params, x, cfg, caches=caches, pos=pos,
                            columns=True)
    return lm_logits(params, h, cfg), caches


def rollback_positions(caches, start, stop):
    """Zero cache positions ``[start[b], stop[b])`` of every row b, in place,
    and return the caches: the speculative un-commit. A freshly initialized
    cache is zero, so "erased" and "never written" are the same state.

    Every leaf is (rep, batch, max_len, ...), position-indexed: GQA's k/v
    and MLA's ckv / kpe (``verify_step`` refuses windowed rings).
    start/stop: (B,) position bounds per row (start >= stop is a no-op for
    that row). Pure masking, exact under every backend."""
    def leaf(x):
        if x.ndim < 3 or x.shape[1] != len(start):
            raise ValueError(f"cache leaf of shape {tuple(x.shape)} is not "
                             f"(rep, {len(start)}, max_len, ...)")
        lo = torch.as_tensor(np.asarray(start), dtype=torch.int64,
                             device=x.device)
        hi = torch.as_tensor(np.asarray(stop), dtype=torch.int64,
                             device=x.device)
        p = torch.arange(x.shape[2], device=x.device)
        drop = (p[None, :] >= lo[:, None]) & (p[None, :] < hi[:, None])
        x.masked_fill_(drop.reshape(1, *drop.shape, *(1,) * (x.ndim - 3)), 0)
        return x

    return map_leaves(leaf, caches)


# ---------------------------------------------------------------------------
# Paged cache indirection (the serving engine's page store)
# ---------------------------------------------------------------------------
#
# A page store is an init_cache tree with (batch -> n_pages, max_len ->
# page_size): every leaf becomes (rep, n_pages, page_size, ...). Gather and
# store move whole pages between the store and a cache row by page index.
# Only position-indexed caches (global GQA, MLA) are paged.

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

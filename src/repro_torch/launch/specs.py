"""Abstract input and state trees for the dry-run, after the JAX package's
``repro.launch.specs``: tensors on the ``meta`` device, with shapes and
dtypes and no storage, so that kimi-k2-1t-a32b's parameters and its
quantized moments stay abstract.

Each tree has the keys, shapes and dtypes of the JAX package's
``ShapeDtypeStruct`` trees for the same cell. The JAX functions also take
a ``Mesh`` and sharding rules and attach shardings; the port's take
neither until training over a mesh (ROADMAP.md queue A, item 23); the
serving engine's shardings are ``TLM.cache_specs`` and
``nn.module.param_specs``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import registry
from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.nn import module as M
from repro_torch.optim import adamw

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def meta_tree(desc_tree):
    """A descriptor tree as meta tensors of its shapes and dtypes."""
    return M.tree_map(lambda d: _meta(d.shape, d.dtype), desc_tree)


def nbytes(tree) -> int:
    """Bytes of every tensor leaf of a tree of dicts and lists."""
    return sum(t.numel() * t.element_size() for _, t in adamw.flatten(tree))


def step_inputs(cfg: ArchConfig, kind: str, batch: int,
                seq: int) -> Dict[str, torch.Tensor]:
    """Abstract inputs of one step of ``kind`` (train, prefill, decode) at
    ``batch`` rows of ``seq`` tokens: token ids (int32), or bf16 frame
    embeddings under ``embed_stub``; a train step's labels, one per
    codebook with ``n_codebooks`` > 1; the encoder states of a
    cross-attention config; a decode step's position."""
    out: Dict[str, torch.Tensor] = {}
    if kind == "train":
        if cfg.embed_stub:
            out["embeds"] = _meta((batch, seq, cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = _meta((batch, seq), torch.int32)
        out["labels"] = _meta((batch, seq, cfg.n_codebooks)
                              if cfg.n_codebooks > 1 else (batch, seq),
                              torch.int32)
        if cfg.cross_every:
            out["enc"] = _meta((batch, cfg.enc_len, cfg.enc_dim),
                               torch.bfloat16)
        return out
    tok_len = seq if kind == "prefill" else 1
    out["tokens"] = (_meta((batch, tok_len, cfg.d_model), torch.bfloat16)
                     if cfg.embed_stub else _meta((batch, tok_len),
                                                  torch.int32))
    if cfg.cross_every:
        out["enc"] = _meta((batch, cfg.enc_len, cfg.enc_dim), torch.bfloat16)
    if kind == "decode":
        out["pos"] = _meta((), torch.int32)
    return out


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Abstract train / serve inputs for one (arch x shape) cell."""
    seq, batch, kind = registry.SHAPES[shape_name]
    return step_inputs(cfg, kind, batch, seq)


def cache_specs(cfg: ArchConfig, shape_name: str, dtype=torch.bfloat16):
    """The abstract cache tree of one cell: ``TLM.init_cache`` at the
    cell's batch and sequence on the meta device (leaves carry the block
    program's leading stacked ``repeat`` dim)."""
    seq, batch, _ = registry.SHAPES[shape_name]
    return TLM.init_cache(cfg, batch, seq, dtype, device=META)


def model_state_specs(cfg: ArchConfig,
                      opt_cfg: Optional[adamw.AdamWConfig] = None):
    """Abstract params, and with ``opt_cfg`` (params, optimizer state)."""
    d = TLM.descs(cfg)
    params = meta_tree(d)
    if opt_cfg is None:
        return params
    return params, meta_tree(adamw.state_descs(d, opt_cfg))

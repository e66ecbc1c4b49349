"""Abstract input and state trees for the dry-run, after the JAX package's
``repro.launch.specs``: tensors on the ``meta`` device, with shapes and
dtypes and no storage, so that kimi-k2-1t-a32b's parameters and its
quantized moments stay abstract.

Each tree has the keys, shapes and dtypes of the JAX package's
``ShapeDtypeStruct`` trees for the same cell. Given ``mesh=`` (a
``DeviceMesh`` or a ``MeshLayout``) and ``rules=``, ``input_specs``,
``cache_specs`` and ``model_state_specs`` return the spec tree beside the
meta tree: each leaf's spec is the JAX package's ``NamedSharding`` spec
for it (pruned, as tuples of axis names with trailing replicated dims
dropped). Parameters and optimizer state are stored by
``nn.module.param_shardings`` (FSDP and tensor parallel, as
``train.steps.TrainPlan`` holds them); inputs go over the batch axes; a
cell's cache has the JAX dry-run's own layout (``_cache_spec``), not the
serving engine's (``TLM.cache_specs``). ``shard_nbytes`` counts one
rank's bytes of a tree.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import registry
from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.nn import module as M
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           axis_sizes, entry_axes, map_specs,
                                           prune_spec)

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


def shard_nbytes(tree, specs, mesh) -> int:
    """One rank's bytes of ``tree`` stored by ``specs`` over ``mesh``: each
    leaf's bytes over the positions of the axes that shard it."""
    sizes = axis_sizes(mesh)
    out = []

    def one(t, spec):
        parts = 1
        for entry in spec:
            for ax in entry_axes(entry):
                parts *= sizes[ax]
        out.append(t.numel() * t.element_size() // parts)
    map_specs(one, tree, specs)
    return sum(out)


def _batch_entry(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def input_specs(cfg: ArchConfig, shape_name: str, mesh=None,
                rules: ShardingRules = DEFAULT_RULES):
    """Abstract train / serve inputs for one (arch x shape) cell; with
    ``mesh``, (inputs, specs): every input's batch dim over the mesh's
    'pod' and 'data' axes, a decode step's position replicated (the JAX
    package's; it reads no rule for them)."""
    seq, batch, kind = registry.SHAPES[shape_name]
    tree = step_inputs(cfg, kind, batch, seq)
    if mesh is None:
        return tree
    entry = _batch_entry(mesh)
    return tree, {k: prune_spec(tuple(t.shape), (entry,) if t.ndim else (),
                                mesh) for k, t in tree.items()}


def _cache_spec(name, leaf, seq: int, batch_ax, seq_ax, model: int) -> tuple:
    """The JAX dry-run's spec of one cache leaf (``spec_for`` of
    ``repro.launch.specs.cache_specs``), before pruning."""
    if name in ("k", "v"):                  # (rep, B, S, H, D)
        s_ax = None if leaf.shape[2] != seq else seq_ax
        if leaf.shape[3] % model == 0:      # TP over the KV heads
            return (None, batch_ax, s_ax, "model", None)
        return (None, batch_ax, s_ax, None, "model")    # ...or head_dim
    if name in ("ckv", "kpe"):              # (rep, B, S, C)
        return (None, batch_ax, seq_ax, None)
    if name == "S":                         # (rep, B, H, N, N)
        return (None, batch_ax, "model", None, None)
    if name == "h":                         # (rep, B, Di, Ns)
        return (None, batch_ax, "model", None)
    if name == "conv":                      # (rep, B, k-1, Di)
        return (None, batch_ax, None, "model")
    return (None, batch_ax) + (None,) * (leaf.ndim - 2)


def cache_specs(cfg: ArchConfig, shape_name: str, dtype=torch.bfloat16,
                mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """The abstract cache tree of one cell: ``TLM.init_cache`` at the
    cell's batch and sequence on the meta device (leaves carry the block
    program's leading stacked ``repeat`` dim). With ``mesh``, (caches,
    specs) by the JAX dry-run's layout: batch over 'pod' and 'data', TP
    over the KV heads (or else head_dim), and for ``long_500k`` at batch 1
    the sequence over 'data'."""
    seq, batch, _ = registry.SHAPES[shape_name]
    tree = TLM.init_cache(cfg, batch, seq, dtype, device=META)
    if mesh is None:
        return tree
    batch_ax = _batch_entry(mesh)
    seq_ax = "data" if (shape_name == "long_500k" and batch == 1) else None
    model = axis_sizes(mesh).get("model", 1)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, str(i)) for i, v in enumerate(node)]
        return prune_spec(tuple(node.shape), _cache_spec(
            name, node, seq, batch_ax, seq_ax, model), mesh)
    return tree, walk(tree)


def model_state_specs(cfg: ArchConfig,
                      opt_cfg: Optional[adamw.AdamWConfig] = None,
                      mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """Abstract params, and with ``opt_cfg`` (params, optimizer state).
    With ``mesh``, each tree is followed by its spec tree: (params,
    specs) or (params, opt, param specs, opt specs)."""
    d = TLM.descs(cfg)
    params = meta_tree(d)
    trees = [params] if opt_cfg is None else [
        params, meta_tree(adamw.state_descs(d, opt_cfg))]
    if mesh is not None:
        trees.append(M.param_shardings(d, rules, mesh))
        if opt_cfg is not None:
            trees.append(M.param_shardings(adamw.state_descs(d, opt_cfg),
                                           rules, mesh))
    return trees[0] if len(trees) == 1 else tuple(trees)

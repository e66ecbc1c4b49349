"""Train and serve steps for the transformer LM, after the JAX package's
``repro.train.steps``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradients by autograd (the
quantized matmuls' straight-through backward; fake-quant under ``qat``),
then one AdamW update, under ``cnn_train.training_numerics`` (no TF32).
The reference jits it; here it runs eagerly, on the device of its
tensors.

Over a mesh (``mesh=``, a ``DeviceMesh`` with the JAX mesh's axis names,
one rank per position) every rank runs the step, SPMD, as the serving
engine's ``MeshPlan`` does (:class:`TrainPlan`):

  * storage: each rank holds its shards of every parameter and AdamW
    state leaf, by ``nn.module.param_shardings`` of the parameter and
    state descriptors (FSDP over 'data'; heads, mlp, vocab and experts
    over 'model');
  * rows: each position of the batch axes ('data'; 'pod' and 'data' on a
    multi-pod mesh) takes its block of the batch along B, the one
    ``torch.chunk`` gives; the 'model' ranks of one data position compute
    the same rows;
  * loss and gradients: the params gathered whole
    (``parallel.collectives.gather_tree``), then the single-device loss and
    gradients on the rank's rows, in ``num_microbatches`` microbatches
    (their float32 gradients summed in order, from the first);
  * the reduction: each rank's gradient sum and loss sum are all-gathered
    as bytes over the batch axes (with one microbatch a rank, the
    gradients in the parameters' dtype, whose float32 conversion is
    exact), and every rank adds them in float32 in rank order, from rank
    0's, and divides by the number of microbatches in all. No collective
    adds floats;
  * the update: the clip's global norm over the whole summed gradient,
    which every rank holds, then each rank updates its own shards. The
    int8 v state is scaled per block of 128 along the last dim; where a
    shard boundary splits a block (or the scales are stored otherwise
    than the codes) the rank gathers that leaf's state, updates the whole
    leaf and keeps its shard, so no scale comes from part of a block.

The contract: with one microbatch per rank the loss, and the gathered
params and AdamW state after every step, equal ``make_train_step(...,
num_microbatches=n)`` on one device bit for bit, n the number of batch
positions: the same microbatches (``torch.chunk``), the same float32 sum
in the same order, the same update on the same numbers (every step of the
update is elementwise or per block). A mixture-of-experts layer routes
its capacity per microbatch on both sides. On the card the bitwise claim
needs deterministic algorithms (``torch.use_deterministic_algorithms``:
the embedding's backward otherwise adds with atomics), on both sides.

With m > 1 microbatches per rank the order of the sum differs: rank r
sums its own m gradients first, ((g_r0 + g_r1) + ...), and the ranks'
sums are then added in rank order, where one device adds all n m
gradients in one chain. Both are float32 sums of the same n m terms, so
each element of the two means differs by at most 2 gamma(n m - 1)
sum_i |g_i| / (n m), gamma(k) = k u / (1 - k u), u = 2^-24 (each
recursive sum is within gamma(n m - 1) sum_i |g_i| of the exact one).
``mesh_grads`` returns that mean; the update then rounds it as any
gradient. A mesh of one position trains unsharded.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.nn import module as M
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           axis_sizes, entry_axes, map_specs,
                                           mesh_positions, position,
                                           prune_spec, slice_leaf)
from repro_torch.train.cnn_train import training_numerics, value_and_grad


def _accumulate(loss_fn, params, parts) -> tuple:
    """(loss sum, float32 gradient sum) over the microbatches ``parts``, in
    order, from the first: the single-device step's accumulation."""
    grads, loss = None, 0.0
    for mb in parts:
        l_i, g = value_and_grad(loss_fn, params, mb)
        flat = adamw.flatten(g)
        if grads is None:
            grads = [(p, t.to(torch.float32)) for p, t in flat]
        else:
            grads = [(p, a + t.to(torch.float32))
                     for (p, a), (_, t) in zip(grads, flat)]
        loss = loss + l_i
    return loss, grads


def _split(batch, n: int) -> list:
    parts = {k: torch.chunk(v, n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    rules: ShardingRules = DEFAULT_RULES,
                    num_microbatches: int = 1, qat: bool = False, *,
                    mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss": loss}).

    ``batch`` holds ``tokens`` (B, S) ids, or ``embeds`` (B, S, D) stub
    embeddings, and ``labels``: (B, S), or (B, S, C) with ``n_codebooks``
    = C > 1; and ``enc`` (B, Se, enc_dim), the encoder states, for a
    config with cross-attention layers. With ``num_microbatches`` > 1
    every key is split along B, the gradients are summed in float32 and
    averaged, as the reference's scan does at its default
    ``accum_dtype``.

    With a ``mesh`` of more than one position, ``params`` and
    ``opt_state`` are this rank's shards (``TrainPlan.shard_params`` /
    ``init_state``) and ``batch`` the whole batch, the same on every rank;
    ``num_microbatches`` counts the rank's own (see the module
    docstring). The step carries its plan as ``train_step.plan``."""

    def loss_fn(params, batch):
        return TLM.forward_loss(params, batch, cfg, qat=qat, training=True)

    if mesh_positions(mesh) > 1:
        plan = TrainPlan(cfg, opt_cfg, mesh, rules)

        def mesh_step(params, opt_state, batch):
            with training_numerics():
                full = plan.full_params(params)
                b0 = C.STATS["bytes"]
                loss, grads = mesh_grads(loss_fn, full, batch, mesh,
                                         num_microbatches, rules)
                plan.stats["grad_bytes"] += C.STATS["bytes"] - b0
                params, opt_state = plan.update(grads, opt_state, params,
                                                full)
            return params, opt_state, {"loss": loss}

        mesh_step.plan = plan
        return mesh_step

    def train_step(params, opt_state, batch):
        with training_numerics():
            if num_microbatches > 1:
                loss, grads = _accumulate(loss_fn, params,
                                          _split(batch, num_microbatches))
                grads = adamw.unflatten(
                    (p, a / num_microbatches) for p, a in grads)
                loss = loss / num_microbatches
            else:
                loss, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss}

    return train_step


def _batch_axes(batch: int, mesh, rules: ShardingRules = DEFAULT_RULES):
    """The mesh axes a batch of ``batch`` rows goes over (rules.batch,
    pruned: none where they do not divide it, and then every rank computes
    every row)."""
    spec = prune_spec((batch,), rules.spec(("batch",), mesh), mesh)
    return entry_axes(spec[0]) if spec else ()


def _gather_positions(xs: List[torch.Tensor], mesh, axes) -> list:
    """Every position's ``xs`` over ``axes`` as bytes, in combined index
    order (major axis first): a list over positions of lists of
    tensors."""
    per = [list(xs)]
    for ax in reversed(axes):
        group = mesh.get_group(ax)
        if torch.distributed.get_world_size(group) == 1:
            continue
        parts = C.all_gather_many([t for pos in per for t in pos], group)
        n, k = len(parts[0]), len(xs)
        per = [[parts[i * k + j][g] for j in range(k)]
               for g in range(n) for i in range(len(per))]
    return per


def mesh_grads(loss_fn, params, batch, mesh, num_microbatches: int = 1,
               rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """(loss, float32 gradients) of the whole batch over ``mesh``: this
    rank's block of rows along B in ``num_microbatches`` microbatches, the
    ranks' sums gathered as bytes over the batch axes and added in rank
    order, divided by the number of microbatches in all (see the module
    docstring). ``params`` are whole. Every rank returns the same bits."""
    rows = next(iter(batch.values())).shape[0]
    axes = _batch_axes(rows, mesh, rules)
    idx, n = position(mesh, axes)
    block = {k: torch.chunk(v, n)[idx] for k, v in batch.items()}
    if num_microbatches == 1:
        # gathered in the parameters' dtype: its float32 conversion is
        # exact, so the sums are the same numbers (half the bytes for bf16)
        loss, g = value_and_grad(loss_fn, params, block)
        loss, grads = 0.0 + loss, adamw.flatten(g)
    else:
        loss, grads = _accumulate(loss_fn, params,
                                  _split(block, num_microbatches))
    loss = torch.as_tensor(loss, dtype=torch.float32)
    per = ([[loss] + [g for _, g in grads]] if n == 1 else
           _gather_positions([loss] + [g for _, g in grads], mesh, axes))
    total, sums = 0.0, None
    for pos in per:
        total = total + pos[0]
        parts = [t.to(torch.float32) for t in pos[1:]]
        sums = parts if sums is None else [a + b for a, b in zip(sums,
                                                                  parts)]
    count = n * num_microbatches
    return total / count, adamw.unflatten(
        (p, a / count) for (p, _), a in zip(grads, sums))


class TrainPlan:
    """How one config's params and AdamW state are stored and updated over
    ``mesh``: the storage specs of both trees, which leaves update by
    shard, and the collective gathers of a step. Every method that moves
    data is collective: every rank calls it, in the same order."""

    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, mesh,
                 rules: ShardingRules = DEFAULT_RULES):
        if not hasattr(mesh, "get_group"):
            raise TypeError(
                f"a mesh of {mesh_positions(mesh)} positions must be a "
                "torch.distributed DeviceMesh, one rank per position")
        self.cfg, self.opt_cfg, self.mesh, self.rules = (cfg, opt_cfg, mesh,
                                                         rules)
        descs = TLM.descs(cfg)
        self.state_descs = adamw.state_descs(descs, opt_cfg)
        self.param_specs = M.param_shardings(descs, rules, mesh)
        self.state_specs = M.param_shardings(self.state_descs, rules, mesh)
        self.specs = {"params": self.param_specs, "opt": self.state_specs}
        # per leaf: whether its state's shards update alone
        self.by_shard = map_specs(self._aligned, descs, self.param_specs,
                                  self.state_specs["params"])
        self.stats = {"param_bytes": 0, "grad_bytes": 0, "state_bytes": 0}

    def _aligned(self, desc, spec, st_specs) -> bool:
        """Whether a leaf's shards hold whole v blocks: its codes and
        scales sharded alike, and a sharded last dim cut at block
        boundaries."""
        if not self.opt_cfg.quantized_state:
            return True
        ndim = len(desc.shape)
        a = tuple(spec) + (None,) * (ndim - len(spec))
        scale = st_specs["v_scale"]
        b = tuple(scale) + (None,) * (ndim - len(scale))
        if a != b:
            return False
        if a[-1] is None:
            return True
        parts = 1
        for ax in entry_axes(a[-1]):
            parts *= axis_sizes(self.mesh)[ax]
        return (desc.shape[-1] // parts) % adamw.VBLOCK == 0

    # ---- storage ---------------------------------------------------------
    def shard_params(self, params):
        """This rank's shards of the whole ``params`` (own storage)."""
        return map_specs(lambda t, s: slice_leaf(t, s, self.mesh).clone(),
                         params, self.param_specs)

    def init_state(self, device):
        """This rank's shards of ``adamw.init``'s state: zero moments, unit
        v scales, a zero count, allocated at the shard shapes only."""
        def one(d, s):
            shape = slice_leaf(torch.empty(d.shape, device="meta"), s,
                               self.mesh).shape
            return M.init_params(M.ParamDesc(
                tuple(shape), d.logical, d.init, dtype=d.dtype), None, device)
        return map_specs(one, self.state_descs, self.state_specs)

    def full_params(self, params):
        """The whole params, every rank's shards gathered (bytes)."""
        b0 = C.STATS["bytes"]
        out = C.gather_tree(params, self.param_specs, self.mesh)
        self.stats["param_bytes"] += C.STATS["bytes"] - b0
        return out

    def full_state(self, state):
        """The whole AdamW state, every rank's shards gathered (for
        checks)."""
        return C.gather_tree(state, self.state_specs, self.mesh)

    # ---- the update --------------------------------------------------------
    def update(self, grads, state, params, full_params):
        """One AdamW step of this rank's shards from the whole float32
        ``grads`` (every rank's the same): the clip's norm over the whole
        gradient; shards of the leaves whose blocks they hold whole
        updated alone, the others' state gathered and updated whole. Returns
        (param shards, state shards)."""
        gnorm = adamw.global_norm([g for _, g in adamw.flatten(grads)])
        whole = []          # (state shards, specs) of the leaves updated whole
        map_specs(lambda ok, st, ss: None if ok else whole.append((st, ss)),
                  self.by_shard, state["params"], self.state_specs["params"])
        b0 = C.STATS["bytes"]
        gathered = iter(C.gather_tree([w[0] for w in whole],
                                      [w[1] for w in whole], self.mesh))
        self.stats["state_bytes"] += C.STATS["bytes"] - b0

        def inputs(ok, spec, g, st, p, pf):     # (grad, state, param)
            if ok:
                return self._shard(g, spec), st, p
            return g, next(gathered), pf

        picked = map_specs(inputs, self.by_shard, self.param_specs, grads,
                           state["params"], params, full_params)
        g_in, s_in, p_in = (map_specs(lambda ok, t, i=i: t[i],
                                      self.by_shard, picked)
                            for i in range(3))
        new_p, new_s = adamw.update(g_in, {"params": s_in,
                                           "count": state["count"]},
                                    p_in, self.opt_cfg, grad_norm=gnorm)
        new_p = map_specs(lambda ok, spec, t: t if ok else
                          self._shard(t, spec).clone(), self.by_shard,
                          self.param_specs, new_p)
        new_s["params"] = map_specs(
            lambda ok, t, spec: t if ok else map_specs(
                lambda x, s: self._shard(x, s).clone(), t, spec),
            self.by_shard, new_s["params"], self.state_specs["params"])
        return new_p, new_s

    def _shard(self, t, spec):
        return slice_leaf(t, spec, self.mesh)


def make_serve_step(cfg: ArchConfig):
    """(params, caches, token, pos, enc=None) -> (next token, caches): one
    greedy decode step over a batch of requests. ``token`` is (B, 1) ids or
    (B, 1, D) stub embeddings; ``enc`` the encoder states of a
    cross-attention config. The next token is (B, 1) int32, or (B, C), one
    code per codebook, with ``n_codebooks`` = C > 1."""

    def serve_step(params, caches, token, pos, enc=None):
        logits, caches = TLM.decode_step(params, token, pos, cfg, caches,
                                         enc=enc)
        last = logits[:, -1] if cfg.n_codebooks > 1 else logits[:, -1:]
        return torch.argmax(last, dim=-1).to(torch.int32), caches

    return serve_step

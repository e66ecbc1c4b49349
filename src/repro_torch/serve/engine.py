"""Continuous-batching inference engine over the quantized backend
registry, after the JAX package's ``repro.serve.engine``.

Fixed-slot decode over a block-paged persistent KV store:

  * one decode workspace, allocated once: every cache leaf has a ``slots``
    batch axis; an attention leaf has ``max_len`` positions (a windowed
    ring min(window, max_len)), an SSM state (RWKV6's, Mamba's) is a row
    with no positions, float32; a request owns exactly one slot row from
    admission to finish and all its decode writes land there
  * decode advances ALL slots each step with a per-slot position vector
    (``models/transformer_lm.decode_step`` with ``pos: (slots,)``); parked
    (free) slots run token 0 at position 0, writing junk into their KV and
    folding it into their SSM state, and admission overwrites the whole
    row, every leaf
  * admission (``scheduler.SlotScheduler``) happens between decode steps:
    a freed slot is refilled at once under the 'continuous' policy instead
    of waiting for the wave to drain
  * prefix cache (``serve/paging.py``): finished sequences are frozen into
    refcounted pages of a shared page store, indexed by a radix tree over
    token ids. Admission matches the new prompt against the tree; cached
    full pages are gathered into the fresh cache row (the copy-on-write
    copy: shared pages are never written) and only the suffix is
    prefilled, at its true absolute offset (``prefill(..., pos_offset=)``)
  * finish reasons are always explicit: 'eos' | 'max_new' | 'max_len'

The model runs through the quant backend registry with
``quantize.for_lm``'s per-token activation scales, so every int8 code and
every integer accumulator of a token is a function of its own row only:
equal whether the request is served alone, in a full batch, admitted
mid-decode into a reused slot, or on a prefix-cache hit. What the port
claims on top of that is token-level: a request's greedy tokens are the
same in all those cases. It makes no bitwise claim for the floats around
the accumulators (norms, attention, the dequant epilogue), since PyTorch's
kernels may choose another reduction order for another batch shape; the
JAX package pins its float order under jit with ``_pin`` instead.

Speculative decoding (``spec=``, serve/speculative.py): a draft proposes
K-1 tokens per slot, the target scores the (slots, K) window in one
``verify_step`` pass, the engine commits the agreeing prefix plus the
target's own token and erases the rejected KV from both pools. The tokens
served are those of sequential decode.

Over a mesh (``mesh=``, a ``DeviceMesh`` with 'data' and 'model' axes,
one rank per position) every rank runs this engine, SPMD: admission, the
prefix cache's index and sampling run identically on every rank, and a
cheap check gathers each step's emitted tokens and raises if the ranks
disagree. Storage is sharded (``MeshPlan``): every rank holds its shards
of the params (``nn.module.param_shardings``: FSDP over 'data',
tensor-parallel over 'model') and of the slot pool and page store
(``TLM.cache_specs``: slot rows or pages over 'data', KV heads over
'model'). Each step all-gathers the params in full, gathers the pool over
its 'model' axes with the slot dim kept local, runs the unchanged
``TLM.decode_step`` / ``verify_step`` on the rank's slot rows, slices the
new cache shard back out, and all-gathers the logits rows so that every
rank samples the same tokens. Prefill of one request runs on every rank
(the reference's is replicated). Only bytes cross ranks; nothing adds
floats across them. A mesh of one position serves unsharded.

There is no counterpart of the reference's ``compiled_fns`` (its jitted
prefill/decode cache): PyTorch runs eagerly. The engine serves token
models without encoder inputs, as the reference's does: a config with
stub embeddings or cross-attention layers raises ``ValueError``
(``check_servable``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.nn.module import param_shardings, resolve_device
from repro_torch.parallel import collectives as C
from repro_torch.parallel.collectives import (gather_leaves, gather_stack,
                                              gather_tree)
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           entry_axes, map_specs,
                                           mesh_positions, position,
                                           prune_spec, slice_leaf)
from repro_torch.serve.metrics import RequestTiming, summarize
from repro_torch.serve.paging import PrefixCache
from repro_torch.serve.sampling import GREEDY, SamplingConfig, sample_token
from repro_torch.serve.scheduler import SlotScheduler

FINISH_REASONS = ("eos", "max_new", "max_len")


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                  # (len,) int32, len >= 1
    max_new: int = 16
    sampling: SamplingConfig = GREEDY
    # per-request speculation cap: None -> the engine's SpecConfig window,
    # 0 -> sequential decode for this request, n -> accept at most n drafts
    # per verify pass (clamped to the engine window). The emitted tokens
    # are the same either way.
    spec_k: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    timing: RequestTiming = dataclasses.field(default_factory=RequestTiming)


def padded_prefill_ok(cfg: ArchConfig) -> bool:
    """Whether prompts may be padded to a length bucket at prefill, and
    whether the prefix cache may page the KV: only position-indexed caches
    (global GQA, MLA) mask padded junk by absolute position and have
    per-position KV to page. Windowed archs (gemma3) and the SSM archs
    (rwkv6, hymba: a state folds every token in, padding included) prefill
    at the exact prompt length and serve unpaged. The same predicate as
    the reference's."""
    return TLM.position_indexed(cfg)


def check_servable(cfg: ArchConfig) -> None:
    """Refuse the configs the engine cannot serve, as the reference's
    cannot: stub embeddings (musicgen; its ``Engine`` asserts that it
    drives token models) and cross-attention layers (llama-3.2-vision; it
    passes no encoder states to prefill and decode, so its first cross
    layer fails). ``train.steps.make_serve_step`` decodes both, with the
    encoder states or frame embeddings given by its caller."""
    if cfg.embed_stub:
        raise ValueError(
            f"{cfg.name} takes stub embeddings (embed_stub): the serving "
            "engine drives token models only")
    if cfg.cross_every:
        raise ValueError(
            f"{cfg.name} has cross-attention layers: the serving engine "
            "passes no encoder states to them")


# ---------------------------------------------------------------------------
# Engine over a mesh: sharded storage, the single-device model per rank
# ---------------------------------------------------------------------------

def _sharded(spec, skip_dim=None) -> bool:
    return any(e is not None and d != skip_dim for d, e in enumerate(spec))


class MeshPlan:
    """How one config's params, slot pool and page store are stored and run
    over ``mesh``: the storage specs (``param_shardings``,
    ``TLM.cache_specs``), this rank's slot rows and pages, and the
    gather / compute / slice of each call. Every method is collective:
    every rank of the mesh calls it, in the same order."""

    def __init__(self, cfg: ArchConfig, mesh, rules: ShardingRules, *,
                 slots: int, max_len: int, cache_dtype, device,
                 n_pages: int = 0, page_size: int = 0):
        if not hasattr(mesh, "get_group"):
            raise TypeError(
                f"a mesh of {mesh_positions(mesh)} positions must be a "
                "torch.distributed DeviceMesh (launch.mesh."
                "make_serving_mesh), one rank per position")
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.device = device
        self.param_specs = param_shardings(TLM.descs(cfg), rules, mesh)
        meta = torch.device("meta")
        self._pool_meta = TLM.init_cache(cfg, slots, max_len, cache_dtype,
                                         meta)
        self.pool_specs = TLM.cache_specs(cfg, self._pool_meta, rules, mesh)
        self.slot_axes, self.slot0, self.local_slots = self._rows(slots)
        self.page_size = page_size
        if n_pages:
            self._pages_meta = TLM.init_page_store(cfg, n_pages, page_size,
                                                   cache_dtype, meta)
            self.page_specs = TLM.cache_specs(cfg, self._pages_meta, rules,
                                              mesh)
            self.page_axes, self.page0, self.local_pages = self._rows(
                n_pages)

    def _rows(self, n: int) -> Tuple[Tuple[str, ...], int, int]:
        """The mesh axes the batch dim of ``n`` rows goes over (none where
        they do not divide it: replicated), this rank's first row and its
        row count."""
        spec = prune_spec((n,), self.rules.spec(("batch",), self.mesh),
                          self.mesh)
        axes = entry_axes(spec[0]) if spec else ()
        idx, parts = position(self.mesh, axes)
        return axes, idx * (n // parts), n // parts

    # ---- storage ---------------------------------------------------------
    def _zeros(self, meta, specs):
        return map_specs(lambda t, s: torch.zeros(
            slice_leaf(t, s, self.mesh).shape, dtype=t.dtype,
            device=self.device), meta, specs)

    def shard_params(self, params):
        """This rank's shards of the full ``params`` (own storage)."""
        return map_specs(lambda t, s: slice_leaf(t, s, self.mesh).clone(),
                         params, self.param_specs)

    def full_params(self, params):
        return gather_tree(params, self.param_specs, self.mesh)

    def init_pool(self):
        return self._zeros(self._pool_meta, self.pool_specs)

    def init_pages(self):
        return self._zeros(self._pages_meta, self.page_specs)

    def full_pool(self, pool):
        """The whole pool, every rank's shards gathered (for checks)."""
        return gather_tree(pool, self.pool_specs, self.mesh)

    # ---- the model on this rank's rows -----------------------------------
    def _local(self, a):
        return a[self.slot0:self.slot0 + self.local_slots]

    def forward(self, fn, params, pool, tok, pos):
        """``fn`` (``TLM.decode_step`` or ``verify_step``) over this rank's
        slot rows of ``tok`` / ``pos`` (full (slots, ...) on every rank):
        params gathered whole, each pool leaf gathered over its 'model'
        axes (its slot dim kept local), the new cache shard sliced back
        into ``pool``; returns the logits of every slot, gathered."""
        cache = gather_tree(pool, self.pool_specs, self.mesh, skip_dim=1)
        logits, cache = fn(self.full_params(params), self._local(tok),
                           self._local(pos), self.cfg, cache)

        def back(t, s, new):
            if _sharded(s, 1):
                t.copy_(slice_leaf(new, s, self.mesh, skip_dim=1))
        map_specs(back, pool, self.pool_specs, cache)
        for ax in reversed(self.slot_axes):
            logits = C.all_gather_dim(logits, self.mesh, ax, 0)
        return logits

    def decode(self, params, pool, tok, pos):
        """-> (every slot's logits, pool), as ``TLM.decode_step``."""
        return self.forward(TLM.decode_step, params, pool, tok, pos), pool

    def verify(self, params, pool, window, pos):
        """-> (every slot's logits, pool), as ``TLM.verify_step``."""
        return self.forward(TLM.verify_step, params, pool, window,
                            pos), pool

    def prefill(self, params, toks, fresh, lengths, off):
        """A batch-1 prefill on every rank (replicated) into the full
        ``fresh`` cache."""
        return TLM.prefill(self.full_params(params), toks, self.cfg, fresh,
                           lengths=lengths, pos_offset=off)

    def write_slot(self, pool, fresh, slot: int):
        """Copy the full batch-1 ``fresh`` into row ``slot`` of the pool,
        on the ranks that hold that row (their head shard)."""
        if not self.slot0 <= slot < self.slot0 + self.local_slots:
            return pool

        def leaf(p, s, o):
            p[:, slot - self.slot0] = slice_leaf(o, s, self.mesh,
                                                 skip_dim=1)[:, 0]
        map_specs(leaf, pool, self.pool_specs, fresh)
        return pool

    def rollback(self, pool, start, stop):
        TLM.rollback_positions(pool, self._local(np.asarray(start)),
                               self._local(np.asarray(stop)))
        return pool

    # ---- the page store ----------------------------------------------------
    def gather_pages(self, fresh, pages, chain):
        """The COW copy of a prefix hit: the chain's pages, wherever they
        live, gathered (pages over their 'data' axes, heads over 'model')
        into positions [0, n * page_size) of the full batch-1 ``fresh``."""
        ids = list(chain)

        def leaf(pg, s):
            sel = pg.new_zeros((pg.shape[0], len(ids), *pg.shape[2:]))
            for i, p in enumerate(ids):
                if self.page0 <= p < self.page0 + self.local_pages:
                    sel[:, i] = pg[:, p - self.page0]
            if self.page_axes:
                stacked = gather_stack(sel, self.mesh, self.page_axes)
                sel = torch.stack([stacked[p // self.local_pages][:, i]
                                   for i, p in enumerate(ids)], dim=1)
            return gather_leaves([sel], [s], self.mesh, skip_dim=1)[0]
        got = map_specs(leaf, pages, self.page_specs)
        return TLM.gather_pages(fresh, got, list(range(len(ids))))

    def store_pages(self, pages, pool, slot: int, page_ids, page_indices):
        """Freeze pages out of row ``slot``: the ranks holding the row send
        its segments over the pool's 'data' axes, and each rank writes the
        pages it holds (its head shard)."""
        ps = self.page_size
        holder = self.slot0 <= slot < self.slot0 + self.local_slots

        def leaf(pg, s, pl):
            row = pl[:, slot - self.slot0] if holder else \
                pl.new_zeros((pl.shape[0], *pl.shape[2:]))
            segs = torch.stack([row[:, i * ps:(i + 1) * ps]
                                for i in page_indices], dim=1)
            if self.slot_axes:
                segs = gather_stack(segs, self.mesh, self.slot_axes)[
                    slot // self.local_slots]
            for j, p in enumerate(page_ids):
                if self.page0 <= p < self.page0 + self.local_pages:
                    pg[:, p - self.page0] = segs[:, j].to(pg.dtype)
        map_specs(leaf, pages, self.page_specs, pool)
        return pages


class Engine:
    """Continuous-batching server for token LMs, on one device or over a
    mesh.

    ``params`` must live on ``device`` (the card unless the caller asks for
    the CPU); the KV pool and the page store are allocated there. With
    ``mesh`` (a ``DeviceMesh`` of more than one position) every rank
    constructs the engine from the same full ``params`` and keeps only its
    shards (see the module docstring); ``rules`` map the logical axes to
    the mesh's."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 admission: str = "continuous",
                 stream: Optional[Callable[[int, int], None]] = None,
                 cache_dtype=torch.float32,
                 prefix_caching: bool = True, page_size: int = 8,
                 cache_pages: Optional[int] = None,
                 mesh=None, spec=None, draft_params=None, device="cuda",
                 rules: ShardingRules = DEFAULT_RULES):
        check_servable(cfg)
        self.device = resolve_device(device)
        if spec is not None:
            # refuse a layout the verify pass cannot roll back before any
            # allocation
            TLM.require_position_indexed(cfg)
            TLM.require_position_indexed(spec.draft_arch(cfg))
        TLM.map_leaves(self._check_device, params)
        if draft_params is not None:
            TLM.map_leaves(self._check_device, draft_params)
        self.cfg = cfg
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        self.stream = stream
        self.sched = SlotScheduler(slots, admission)
        self._cache_dtype = cache_dtype
        # a mesh of one position adds nothing: serve unsharded
        self.mesh = mesh if mesh_positions(mesh) > 1 else None
        self.page_size = page_size
        self.prefix: Optional[PrefixCache] = None
        n_pages = 0
        if prefix_caching and padded_prefill_ok(cfg) \
                and 0 < page_size <= max_len:
            n_pages = cache_pages or 2 * slots * (max_len // page_size)
            self.prefix = PrefixCache(page_size, n_pages)
        self.plan: Optional[MeshPlan] = None
        if self.mesh is not None:
            self.plan = MeshPlan(cfg, self.mesh, rules, slots=slots,
                                 max_len=max_len, cache_dtype=cache_dtype,
                                 device=self.device, n_pages=n_pages,
                                 page_size=page_size)
            self.params = self.plan.shard_params(params)
            self.pool = self.plan.init_pool()
            self.pages = self.plan.init_pages() if n_pages else None
            self._prefill = self.plan.prefill
            self._decode = self.plan.decode
            self._verify = self.plan.verify
        else:
            self.params = params
            self.pool = TLM.init_cache(cfg, slots, max_len, cache_dtype,
                                       self.device)
            self.pages = (TLM.init_page_store(cfg, n_pages, page_size,
                                              cache_dtype, self.device)
                          if n_pages else None)
            self._prefill = lambda p, t, c, lengths, off: TLM.prefill(
                p, t, cfg, c, lengths=lengths, pos_offset=off)
            self._decode = lambda p, c, t, pos: TLM.decode_step(p, t, pos,
                                                                cfg, c)
            self._verify = lambda p, c, w, pos: TLM.verify_step(p, w, pos,
                                                                cfg, c)
        self._slot_req: List[Optional[ServeRequest]] = [None] * slots
        self._tok = np.zeros(slots, np.int32)     # next input token per slot
        self._pos = np.zeros(slots, np.int32)     # its absolute position
        self._emitted: List[int] = []             # this step's, for agree
        self.completed: List[ServeRequest] = []
        self.decode_steps = 0
        self.busy_slot_steps = 0
        self.prefills = 0
        self.prefill_tokens = 0       # real (unpadded) tokens prefilled
        self.prefix_hit_tokens = 0    # prompt tokens served from the cache
        self._slot_chain: List[Tuple[int, ...]] = [()] * slots
        # ---- draft-model speculation (serve/speculative.py)
        self.speculator = None
        if spec is not None:
            from repro_torch.serve.speculative import Speculator
            self.speculator = Speculator(
                spec, cfg, self.params, draft_params, slots=slots,
                max_len=max_len, cache_dtype=cache_dtype,
                device=self.device, mesh=self.mesh, rules=rules)

    def _check_device(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"params on {t.device}, engine on "
                             f"{self.device}: move the params (or pass "
                             f"device=) first")

    # ---- request intake --------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        req.prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        limit = TLM.prefill_limit(self.cfg, self.max_len)
        if limit is not None and len(req.prompt) > limit:
            raise ValueError(
                f"request {req.rid}: a prompt of {len(req.prompt)} tokens "
                f"is longer than the {limit}-slot ring buffer of "
                f"{self.cfg.name}'s windowed layers, which a prefill "
                "cannot write (nn/attention.py)")
        # reset engine-owned state so a caller may resubmit the same
        # request object to another run
        req.output = []
        req.finish_reason = None
        req.timing = RequestTiming(submit_t=time.time())
        self.sched.submit(req)

    # ---- admission -------------------------------------------------------
    def _bucket(self, plen: int, offset: int = 0) -> int:
        """Prefill length: next power of two >= plen (at least 8, capped so
        that offset + bucket stays inside the cache), as the reference
        buckets its compiled shapes; the exact length where padding is
        unsafe (``padded_prefill_ok``: a ring would alias the padded junk
        onto real positions)."""
        if not padded_prefill_ok(self.cfg):
            return plen
        bucket = 8
        while bucket < plen:
            bucket *= 2
        return min(bucket, self.max_len - offset)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _admit(self) -> None:
        for slot, req in self.sched.admit():
            plen = len(req.prompt)
            if plen > self.max_len:
                # rejected before prefill: no room for even the prompt
                req.finish_reason = "max_len"
                self._retire(slot, store=False)
                continue
            # longest cached full-page prefix, capped at plen-1 so at
            # least one suffix token remains to produce the first logits
            chain: Tuple[int, ...] = ()
            hit = 0
            if self.prefix is not None:
                chain = tuple(self.prefix.match(req.prompt[:plen - 1]))
                hit = len(chain) * self.page_size
                if chain:
                    self.prefix.acquire(chain)   # pinned until retirement
                    self.prefix_hit_tokens += hit
            self._slot_chain[slot] = chain
            suffix = req.prompt[hit:]
            bucket = self._bucket(len(suffix), offset=hit)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :len(suffix)] = suffix
            fresh = TLM.init_cache(self.cfg, 1, self.max_len,
                                   self._cache_dtype, self.device)
            if chain:
                # the COW copy: shared pages -> this request's private row
                fresh = (self.plan.gather_pages(fresh, self.pages, chain)
                         if self.plan else
                         TLM.gather_pages(fresh, self.pages, chain))
            logits, fresh = self._prefill(
                self.params, self._tensor(toks), fresh,
                self._tensor([len(suffix)]), hit)
            self.prefills += 1
            self.prefill_tokens += len(suffix)
            # full-row copy: the freed slot inherits nothing from its
            # previous occupant (no KV leakage on reuse)
            self.pool = (self.plan.write_slot(self.pool, fresh, slot)
                         if self.plan else
                         TLM.write_slot(self.pool, fresh, slot))
            self._slot_req[slot] = req
            self._pos[slot] = plen
            if req.max_new <= 0:
                req.finish_reason = "max_new"
            else:
                row = logits[0, 0].cpu().numpy()
                self._emit(req, sample_token(row, req.sampling, req.rid, 0))
            if req.finish_reason:
                self._retire(slot)
            else:
                self._tok[slot] = req.output[-1]
                if self.speculator is not None:
                    # draft-side cold prefill of the full prompt (the draft
                    # never reads the paged prefix store)
                    self.speculator.admit(slot, req.prompt, self._bucket)

    # ---- token emission / finish ----------------------------------------
    def _emit(self, req: ServeRequest, tok: int) -> None:
        req.output.append(tok)
        self._emitted.append(tok)
        if req.timing.first_token_t is None:
            req.timing.first_token_t = time.time()
        if self.stream is not None:
            self.stream(req.rid, tok)
        if self.eos_id is not None and tok == self.eos_id:
            req.finish_reason = "eos"
        elif len(req.output) >= req.max_new:
            req.finish_reason = "max_new"
        elif len(req.prompt) + len(req.output) - 1 >= self.max_len:
            # the next decode would write KV past the cache ceiling —
            # report it instead of silently truncating
            req.finish_reason = "max_len"

    def _retire(self, slot: int, store: bool = True) -> None:
        req = self.sched.release(slot)
        req.timing.done_t = time.time()
        if self.prefix is not None:
            if store:
                self._store_pages(slot, req)
            if self._slot_chain[slot]:
                self.prefix.release(self._slot_chain[slot])
            self._slot_chain[slot] = ()
        self._slot_req[slot] = None
        self._tok[slot] = 0
        self._pos[slot] = 0     # park: writes land at pos 0 of a dead row
        #                         and are overwritten by the next admission
        self.completed.append(req)

    def _store_pages(self, slot: int, req: ServeRequest) -> None:
        """Publish this request's KV to the prefix cache. KV exists for
        positions [0, plen + m - 1): the prompt plus every generated token
        that was fed back (the last sampled token never was), so the
        cacheable key is prompt ++ output[:-1]."""
        seq = req.prompt if not req.output else np.concatenate(
            [req.prompt, np.asarray(req.output[:-1], np.int32)])
        new = self.prefix.insert(seq)
        if new:
            store = self.plan.store_pages if self.plan else TLM.store_pages
            self.pages = store(self.pages, self.pool, slot,
                               [p for p, _ in new], [i for _, i in new])

    # ---- the serving loop ------------------------------------------------
    def _spec_eligible(self, active: List[int]) -> bool:
        """A spec pass needs every active slot's K window positions in
        bounds (a row cannot opt out of the batched verify), and at least
        one request that wants drafts. Near the cache ceiling the engine
        falls back to plain steps; mixing pass kinds never changes the
        served tokens."""
        if self.speculator is None:
            return False
        k = self.speculator.spec.k
        if any(self._pos[s] + k > self.max_len for s in active):
            return False
        return any((self._slot_req[s].spec_k is None
                    or self._slot_req[s].spec_k > 0) for s in active)

    def step(self) -> bool:
        """Admit into free slots, then one pass over the whole pool: a
        (slots, K) speculative verify pass when configured and in bounds, a
        (slots, 1) decode step otherwise. Returns False once queue and pool
        are both empty. Over a mesh, the tokens emitted in the call are
        checked equal on every rank."""
        try:
            return self._step()
        finally:
            if self.mesh is not None:
                C.agree(self._emitted, self.mesh, "emitted tokens")
            self._emitted.clear()

    def _step(self) -> bool:
        with torch.no_grad():
            self._admit()
            active = [s for s in range(self.slots) if self._slot_req[s]]
            if not active:
                return not self.sched.idle
            if self._spec_eligible(active):
                self._spec_step(active)
                return True
            if self.speculator is not None:
                # keep the draft pool on the true stream through the
                # fallback
                self.speculator.advance(self._tok, self._pos)
            logits, self.pool = self._decode(
                self.params, self.pool, self._tensor(self._tok[:, None]),
                self._tensor(self._pos))
            rows = logits[:, 0].cpu().numpy()        # one host transfer
        self.decode_steps += 1
        self.busy_slot_steps += len(active)
        for s in active:
            req = self._slot_req[s]
            self._pos[s] += 1
            tok = sample_token(rows[s], req.sampling, req.rid,
                               len(req.output))
            self._emit(req, tok)
            if req.finish_reason:
                self._retire(s)
            else:
                self._tok[s] = tok
        return True

    def _spec_step(self, active: List[int]) -> None:
        """One draft-propose / target-verify / commit / rollback pass.

        Commits n in [1, K] tokens per active slot: emission j samples
        verify logits row j keyed by the committed-token counter, and goes
        on while the emitted token equals the draft the next row was
        verified against. Rejected window positions are erased from both
        pools before any retirement publishes pages, so every row ends in
        its sequential-decode state."""
        spec = self.speculator
        k = spec.spec.k
        p0 = self._pos.copy()
        window = spec.propose(self._tok, self._pos)
        logits, self.pool = self._verify(self.params, self.pool,
                                         self._tensor(window),
                                         self._tensor(p0))
        rows = logits.cpu().numpy()                 # one host transfer
        self.decode_steps += 1
        self.busy_slot_steps += len(active)
        spec.metrics.passes += 1
        frontier = p0.copy()                        # rollback start/slot
        retired: List[int] = []
        for s in active:
            req = self._slot_req[s]
            cap = k if req.spec_k is None else 1 + min(max(req.spec_k, 0),
                                                       k - 1)
            emitted = 0
            for j in range(cap):
                tok = sample_token(rows[s, j], req.sampling, req.rid,
                                   len(req.output))
                self._emit(req, tok)
                emitted += 1
                if req.finish_reason:
                    break
                # go on only while the next verified row consumed this
                # exact token (the draft proposal at window j+1)
                if j + 1 >= cap or tok != window[s, j + 1]:
                    break
            spec.metrics.record(drafted=cap - 1, committed=emitted)
            frontier[s] = p0[s] + emitted
            if req.finish_reason:
                retired.append(s)
            else:
                self._tok[s] = req.output[-1]
                self._pos[s] = p0[s] + emitted
        # un-commit rejected positions [frontier, p0 + K) in both pools.
        # Parked rows (frontier == p0 == 0) collected junk at [0, K) during
        # the pass: erased the same way.
        stop = p0 + k
        if self.plan:
            self.plan.rollback(self.pool, frontier, stop)
        else:
            TLM.rollback_positions(self.pool, frontier, stop)
        spec.rollback(frontier, stop)
        for s in retired:
            self._retire(s)

    def run(self) -> Dict:
        """Serve until the queue drains; returns the stats summary."""
        t0 = time.time()
        while self.step():
            pass
        return summarize(self.completed, time.time() - t0,
                         n_slots=self.slots, decode_steps=self.decode_steps,
                         busy_slot_steps=self.busy_slot_steps,
                         prefills=self.prefills, waves=self.sched.waves,
                         prefill_tokens=self.prefill_tokens,
                         prefix_hit_tokens=self.prefix_hit_tokens,
                         prefix_stats=(self.prefix.stats()
                                       if self.prefix else None),
                         spec=(self.speculator.metrics.summary()
                               if self.speculator else None))

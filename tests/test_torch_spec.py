"""The port's speculative decoding against the JAX package's, and its own
acceptance contract.

The model is the reduced smollm of the JAX package's speculative tests (2
layers, d_model 64, 4 heads / 2 KV heads of 16, d_ff 128, vocab 64), its
weights the JAX package's ``TLM.init`` at key 0 carried across by
``repro_torch.convert``. Where a backend has an oracle, the JAX engine runs
the oracle and the port the backend itself (``*_pallas``: on the CPU, its
kernels' plain versions).

What is claimed, with its tolerance:
  * ``verify_step`` row j equals the j-th sequential ``decode_step`` row
    bit for bit, and its cache writes equal theirs, for every integer
    backend; under bf16 the rows agree within BF16_ROW_RTOL of their range
    (its float projections are not row-local on the card; on the CPU they
    happen to be equal too);
  * greedy speculative tokens equal the JAX engine's speculative tokens,
    per backend and window K (approx_stage1 draft);
  * the port's own speculative tokens equal its sequential tokens, per
    backend, draft, K, per-request cap, with prefix-cache hits, at the
    max_len ceiling, and for sampled streams;
  * rollback leaves the pool and the published pages bitwise equal to the
    sequential engine's, with refcounts conserved.
"""
import dataclasses
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import _torch_refs as REFS
from _hypothesis_compat import given, settings, st
from repro.configs import registry as RR
from repro.quant import matmul as RQM
from repro.serve import engine as RE
from repro.serve import speculative as RSP

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer_lm as PT
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import for_lm
from repro_torch.serve import (GREEDY, Engine, SamplingConfig, ServeRequest,
                               SpecConfig, SpecMetrics)
from repro_torch.serve.speculative import acceptance

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64, vocab_pad=64, head_dim=16)
MAX_LEN = 32
BACKENDS = ("bf16",) + QM.list_backends()
# bf16 verify rows against sequential rows: within this share of the row's
# range (the float32 projections may round differently at width K; on the
# card measured at 4.2e-7, chip_smoke.py's spec phase)
BF16_ROW_RTOL = 1e-5
STAGE1 = SpecConfig(k=4, draft_backend="approx_stage1")


@functools.lru_cache(maxsize=None)
def _tiny():
    rcfg = RR.reduced("smollm-135m", **TINY)
    pcfg = PR.reduced("smollm-135m", **TINY)
    rparams = REFS.init(rcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams),
                              device="cpu")
    return rcfg, pcfg, rparams, pparams


def _cfg(backend):
    return dataclasses.replace(_tiny()[1], quant=for_lm(backend))


def _mixed_reqs(seed=3, n=5, sampling=None, spec_k=None, module=None):
    """More requests than the 3-slot pool: the tail is admitted mid-decode
    into reused slots."""
    rng = np.random.default_rng(seed)
    lens, news = rng.integers(2, 10, n), rng.integers(3, 9, n)
    make = ServeRequest if module is None else module.ServeRequest
    return [make(rid=rid,
                 prompt=rng.integers(0, TINY["vocab"], int(lens[rid]))
                 .astype(np.int32),
                 max_new=int(news[rid]), sampling=sampling or GREEDY,
                 spec_k=spec_k)
            for rid in range(n)]


def _serve(cfg, reqs, *, spec=None, slots=3, max_len=MAX_LEN, **kw):
    eng = Engine(cfg, _tiny()[3], slots=slots, max_len=max_len, spec=spec,
                 device="cpu", **kw)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return {r.rid: list(r.output) for r in eng.completed}, stats, eng


def _leaves(tree):
    out = []
    PT.map_leaves(out.append, tree)
    return out


def _shared_prompts(seed, suffixes=(4, 3, 5)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, TINY["vocab"], 8).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, TINY["vocab"], n)
                            .astype(np.int32)]) for n in suffixes]


def _check_hist(stats):
    hist = stats["spec_accept_hist"]
    assert stats["spec_committed"] == sum((a + 1) * n
                                          for a, n in enumerate(hist)), \
        "committed != accepted + 1 summed over verify outcomes"


# ---------------------------------------------------------------------------
# The model-level foundation: verify_step == K sequential decode_steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_verify_step_bitwise_equals_sequential_decode(backend):
    cfg, params = _cfg(backend), _tiny()[3]
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 5)))
    pos = torch.tensor([5, 5, 5])
    with torch.no_grad():
        cache = PT.init_cache(cfg, 3, MAX_LEN, torch.float32, "cpu")
        logits, cache = PT.prefill(params, prompt, cfg, cache)
        vcache = PT.map_leaves(lambda t: t.clone(), cache)
        toks, seq = [logits[:, -1].argmax(-1)], []
        for j in range(4):
            lg, cache = PT.decode_step(params, toks[-1][:, None], pos + j,
                                       cfg, cache)
            seq.append(lg[:, 0])
            toks.append(lg[:, 0].argmax(-1))
        vlg, vcache = PT.verify_step(params, torch.stack(toks[:4], 1), pos,
                                     cfg, vcache)
    for j in range(4):
        if backend == "bf16":
            span = float(seq[j].max() - seq[j].min())
            np.testing.assert_allclose(vlg[:, j].numpy(), seq[j].numpy(),
                                       rtol=0, atol=BF16_ROW_RTOL * span)
        else:
            assert torch.equal(vlg[:, j], seq[j]), \
                f"{backend}: verify row {j} != sequential logits"
    if backend != "bf16":
        for a, b in zip(*(_leaves(c) for c in (vcache, cache))):
            assert torch.equal(a, b), f"{backend}: verify cache writes " \
                                      "!= sequential"


def test_rollback_positions_erases_exactly_the_suffix():
    cfg = _tiny()[1]
    pool = PT.map_leaves(torch.ones_like,
                         PT.init_cache(cfg, 3, 16, torch.float32, "cpu"))
    start, stop = np.array([4, 0, 16]), np.array([8, 16, 16])
    out = PT.rollback_positions(pool, start, stop)
    assert all(a is b for a, b in zip(_leaves(out), _leaves(pool))), \
        "rollback did not write the pool in place"
    for arr in _leaves(out):
        for s in range(3):
            row = arr[:, s]
            lo, hi = start[s], stop[s]
            assert (row[:, lo:hi] == 0).all(), "suffix not erased"
            assert (row[:, :lo] == 1).all(), "prefix was touched"
            assert (row[:, hi:] == 1).all(), "tail past stop was touched"


# ---------------------------------------------------------------------------
# Against the JAX package's speculative engine
# ---------------------------------------------------------------------------

def _ref_backend(name):
    if name == "bf16":
        return name
    return RQM.get_backend(name).oracle or name


@functools.lru_cache(maxsize=None)
def _jax_spec_served(backend, k):
    rcfg, _, rparams, _ = _tiny()
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    eng = RE.Engine(cfg, rparams, slots=3, max_len=MAX_LEN,
                    spec=RSP.SpecConfig(k=k, draft_backend="approx_stage1"))
    for r in _mixed_reqs(module=RE):
        eng.submit(r)
    stats = eng.run()
    return {r.rid: list(r.output) for r in eng.completed}, stats


@pytest.mark.parametrize("backend,k", [
    (b, 4) for b in ("bf16", "int8_exact", "approx_lut",
                     "approx_deficit_pallas", "approx_stage1_pallas",
                     "approx_rank1_pallas")] + [
    ("int8_exact", 1), ("int8_exact", 2)])
def test_spec_tokens_equal_the_reference_engine(backend, k):
    want, want_stats = _jax_spec_served(_ref_backend(backend), k)
    got, stats, _ = _serve(_cfg(backend), _mixed_reqs(),
                           spec=SpecConfig(k=k,
                                           draft_backend="approx_stage1"))
    assert got == want, f"{backend} K={k}: port spec != JAX spec"
    for key in ("spec_passes", "spec_committed", "spec_accept_hist",
                "decode_steps", "waves"):
        assert stats[key] == want_stats[key], key


# ---------------------------------------------------------------------------
# The parity matrix: spec serve == sequential serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_spec_matches_sequential_per_backend(backend):
    cfg = _cfg(backend)
    seq, seq_stats, _ = _serve(cfg, _mixed_reqs())
    spc, stats, _ = _serve(cfg, _mixed_reqs(), spec=STAGE1)
    assert seq_stats["waves"] >= 2, "workload lost its mid-decode admission"
    assert spc == seq, f"{backend}: speculative tokens != sequential"
    assert stats["spec_passes"] > 0
    assert stats["spec_committed"] >= stats["spec_passes"]
    _check_hist(stats)


@pytest.mark.parametrize("draft,k", [
    ("approx_stage1", 1), ("approx_stage1", 2), ("approx_stage1", 8),
    ("bf16", 4), ("approx_lut", 4), ("int8_exact", 4)])
def test_spec_matches_sequential_draft_and_k_sweep(draft, k):
    cfg = _cfg("int8_exact")
    seq, _, _ = _serve(cfg, _mixed_reqs(seed=7))
    spc, stats, _ = _serve(cfg, _mixed_reqs(seed=7),
                           spec=SpecConfig(k=k, draft_backend=draft))
    assert spc == seq, f"draft={draft} K={k}: speculative != sequential"
    assert len(stats["spec_accept_hist"]) == k


def test_smaller_draft_model_config():
    draft_cfg = PR.reduced("smollm-135m", n_layers=1, d_model=32, n_heads=2,
                           n_kv_heads=1, d_ff=64, vocab=64, vocab_pad=64,
                           head_dim=16)
    draft_params = PT.init(draft_cfg, torch.Generator().manual_seed(7),
                           device="cpu")
    cfg = _cfg("int8_exact")
    seq, _, _ = _serve(cfg, _mixed_reqs(seed=9))
    spc, stats, _ = _serve(cfg, _mixed_reqs(seed=9),
                           spec=SpecConfig(k=4, draft_cfg=draft_cfg),
                           draft_params=draft_params)
    assert spc == seq, "smaller-draft speculative != sequential"
    assert stats["spec_passes"] > 0
    with pytest.raises(ValueError, match="draft_params"):
        _serve(cfg, [], spec=SpecConfig(k=4, draft_cfg=draft_cfg))


def test_self_draft_reaches_full_acceptance():
    cfg = _cfg("int8_exact")

    def req():
        return [ServeRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                             max_new=12)]

    seq, seq_stats, _ = _serve(cfg, req(), slots=1)
    spc, stats, _ = _serve(cfg, req(), slots=1,
                           spec=SpecConfig(k=4, draft_backend="int8_exact"))
    assert spc == seq
    assert stats["decode_steps"] < seq_stats["decode_steps"]
    hist = stats["spec_accept_hist"]
    assert sum(hist[:-1]) <= 1, f"self-draft rejected drafts: {hist}"


# ---------------------------------------------------------------------------
# Composition: prefix-cache hits, per-request caps, ceiling fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["bf16", "int8_exact",
                                     "approx_stage1_pallas"])
def test_spec_on_prefix_cache_hit_equals_cold(backend):
    cfg = _cfg(backend)
    pa, pb, _ = _shared_prompts(seed=21)
    warm = Engine(cfg, _tiny()[3], slots=2, max_len=MAX_LEN, page_size=4,
                  spec=STAGE1, device="cpu")
    warm.submit(ServeRequest(rid=0, prompt=pa, max_new=4))
    warm.run()
    warm.submit(ServeRequest(rid=1, prompt=pb, max_new=5))
    warm.run()
    assert warm.prefix_hit_tokens >= 8, "request B missed the shared prefix"
    hit = next(r for r in warm.completed if r.rid == 1).output
    cold, _, _ = _serve(cfg, [ServeRequest(rid=1, prompt=pb, max_new=5)],
                        slots=2, spec=STAGE1, page_size=4)
    seq, _, _ = _serve(cfg, [ServeRequest(rid=1, prompt=pb, max_new=5)],
                       slots=2, page_size=4)
    assert hit == cold[1] == seq[1], (
        f"{backend}: hit={hit} cold={cold[1]} sequential={seq[1]}")


def test_per_request_spec_k_caps_do_not_change_tokens():
    cfg = _cfg("int8_exact")
    seq, _, _ = _serve(cfg, _mixed_reqs(seed=11))
    reqs = _mixed_reqs(seed=11)
    for r, c in zip(reqs, [0, 1, None, 2, 0]):
        r.spec_k = c
    spc, stats, _ = _serve(cfg, reqs, spec=STAGE1)
    assert spc == seq, "per-request spec_k changed decoded tokens"
    _check_hist(stats)
    # every request opting out: plain passes only
    seq, _, _ = _serve(cfg, _mixed_reqs(seed=13, n=3))
    spc, stats, _ = _serve(cfg, _mixed_reqs(seed=13, n=3, spec_k=0),
                           spec=SpecConfig(k=4, draft_backend="bf16"))
    assert spc == seq
    assert stats["spec_passes"] == 0, \
        "engine ran verify passes for a workload that opted out"


def test_max_len_ceiling_falls_back_to_sequential_passes():
    cfg = _cfg("int8_exact")

    def long_reqs():
        rng = np.random.default_rng(17)
        return [ServeRequest(rid=rid,
                             prompt=rng.integers(0, TINY["vocab"], 26 + rid)
                             .astype(np.int32), max_new=10)
                for rid in range(2)]

    seq, _, _ = _serve(cfg, long_reqs(), slots=2)
    spc, stats, _ = _serve(cfg, long_reqs(), slots=2,
                           spec=SpecConfig(k=8, draft_backend="bf16"))
    assert spc == seq
    assert stats["spec_passes"] == 0 < stats["decode_steps"]
    assert all(0 < len(t) <= 10 for t in spc.values())


def test_spec_requires_position_indexed_caches():
    cfg, params = _tiny()[1], _tiny()[3]
    windowed = dataclasses.replace(cfg, local_window=8)
    with pytest.raises(ValueError, match="position-indexed"):
        Engine(windowed, params, slots=2, max_len=MAX_LEN,
               spec=SpecConfig(k=4), device="cpu")
    with pytest.raises(ValueError, match="position-indexed"):
        PT.verify_step(params, torch.zeros((1, 2), dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int64), windowed, None)
    with pytest.raises(ValueError, match="SpecConfig.k"):
        SpecConfig(k=0)


# ---------------------------------------------------------------------------
# Sampled streams: spec on == spec off (committed-token keying)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scfg", [
    SamplingConfig(kind="temperature", temperature=1.3, seed=5),
    SamplingConfig(kind="top_k", top_k=8, temperature=0.9, seed=6),
])
def test_sampled_stream_spec_on_equals_off(scfg):
    cfg = _cfg("int8_exact")
    seq, _, _ = _serve(cfg, _mixed_reqs(seed=19, sampling=scfg))
    spc, stats, _ = _serve(cfg, _mixed_reqs(seed=19, sampling=scfg),
                           spec=SpecConfig(k=4, draft_backend="bf16"))
    assert spc == seq, f"{scfg.kind}: sampled stream diverged under spec"
    assert stats["spec_passes"] > 0


# ---------------------------------------------------------------------------
# State invariants: rollback, page publication, refcounts
# ---------------------------------------------------------------------------

def test_pool_row_bitwise_equal_after_speculative_run():
    cfg = _cfg("int8_exact")

    def mk():
        return [ServeRequest(rid=0, prompt=np.arange(5, dtype=np.int32),
                             max_new=9)]

    _, _, seq_eng = _serve(cfg, mk(), slots=1, prefix_caching=False)
    _, _, spc_eng = _serve(cfg, mk(), slots=1, prefix_caching=False,
                           spec=STAGE1)
    frontier = 5 + 9 - 1                 # plen + committed - 1
    for a, b in zip(_leaves(spc_eng.pool),
                    _leaves(seq_eng.pool)):
        assert torch.equal(a, b), \
            "speculative pool row != sequential pool row"
        assert (a[:, :, frontier:] == 0).all(), \
            "speculative KV survived past the committed frontier"
    # the draft pool too: zeros past the frontier, as a fresh row
    for a in _leaves(spc_eng.speculator.pool):
        assert (a[:, :, frontier:] == 0).all(), \
            "draft KV survived past the committed frontier"


def test_published_pages_identical_and_refcounts_conserved():
    cfg = _cfg("int8_exact")
    prompts = _shared_prompts(seed=23)

    def mk():
        return [ServeRequest(rid=i, prompt=p, max_new=m)
                for i, (p, m) in enumerate(zip(prompts, (6, 4, 5)))]

    _, _, seq_eng = _serve(cfg, mk(), slots=2, page_size=4)
    _, _, spc_eng = _serve(cfg, mk(), slots=2, page_size=4, spec=STAGE1)
    for eng in (seq_eng, spc_eng):
        pages = eng.prefix.pages()
        assert all(eng.prefix.pool.refcount(p) == 1 for p in pages), \
            "page refcounts did not balance after retirement"
        assert len(pages) + eng.prefix.pool.n_free == eng.prefix.pool.n_pages
    assert spc_eng.prefix.n_nodes == seq_eng.prefix.n_nodes
    sa, sb = sorted(spc_eng.prefix.pages()), sorted(seq_eng.prefix.pages())
    assert sa == sb
    for a, b in zip(_leaves(spc_eng.pages),
                    _leaves(seq_eng.pages)):
        assert torch.equal(a[:, sa], b[:, sb]), \
            "published page contents differ under speculation"


# ---------------------------------------------------------------------------
# Bookkeeping properties
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(1, 8), st.lists(st.integers(0, 63), min_size=1,
                                   max_size=8),
       st.lists(st.integers(0, 63), min_size=1, max_size=9))
def test_acceptance_bookkeeping_property(k, window, emitted):
    window = np.asarray((window + [0] * k)[:k], np.int32)
    emitted = emitted[:k]
    a = acceptance(window, emitted)
    assert a == RSP.acceptance(window, emitted)
    assert 0 <= a <= min(len(emitted) - 1, k - 1)
    for j in range(a):
        assert emitted[j] == window[j + 1]
    if a < len(emitted) - 1 and a + 1 < k:
        assert emitted[a] != window[a + 1]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 6), min_size=1, max_size=30))
def test_spec_metrics_committed_equals_accepted_plus_outcomes(commits):
    k = max(commits)
    m, ref = SpecMetrics(k), RSP.SpecMetrics(k)
    for c in commits:
        m.record(drafted=k - 1, committed=c)
        ref.record(drafted=k - 1, committed=c)
    s = m.summary()
    assert s == ref.summary()
    outcomes = sum(s["spec_accept_hist"])
    accepted = sum(a * n for a, n in enumerate(s["spec_accept_hist"]))
    assert outcomes == len(commits)
    assert s["spec_committed"] == accepted + outcomes

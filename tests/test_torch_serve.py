"""The port's serving stack (scheduler, paging, sampling, the engine)
against the JAX package's, and the engine's own invariances.

The model is the reduced smollm of the JAX package's serving tests (2
layers, d_model 64, 4 heads / 2 KV heads of 16, d_ff 128, vocab 64), its
weights the JAX package's ``TLM.init`` at key 0 carried across by
``repro_torch.convert``. Where a backend has an oracle, the JAX engine runs
the oracle (the JAX package's tests hold its ``*_pallas`` entries to theirs
bitwise) and the port runs the backend itself (``*_pallas``: on the CPU,
its kernels' plain versions).

What is claimed:
  * greedy served tokens equal the JAX engine's on a mixed workload with a
    shared prefix, mid-decode admission and prefix-cache hits; every
    compared logits row agrees within ROW_RTOL of its range and its top-2
    gap exceeds twice that, so the equality is not a near-tie's luck;
  * the port's own token-level invariances, per backend: served alone ==
    in a full batch == admitted mid-decode on a prefix-cache hit == cold
    with the prefix cache off == a hand-rolled greedy decode;
  * the copied scheduler and paging pass the reference's property cases,
    and behave step for step as the reference classes do.
The JAX package's float-path contracts that fail on the CPU
(``test_serve::test_vector_pos_decode_matches_scalar[smollm-135m]``,
``test_serve::test_prefill_lengths_gathers_true_last_token``; ROADMAP
queue C) are not taken as met: the invariances here are the port's own
claims, at the token level.
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
from repro.serve import paging as RPG
from repro.serve import scheduler as RS

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer_lm as PT
from repro_torch.parallel.sharding import MeshLayout
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import for_lm
from repro_torch.serve import (Engine, FINISH_REASONS, PagePool, PrefixCache,
                               SamplingConfig, ServeRequest, SlotScheduler,
                               SpecConfig, padded_prefill_ok, sample_token)
from repro_torch.serve import __main__ as CLI
from repro_torch.serve import engine as PE
from repro_torch.serve import sampling as PS
from repro_torch.train.serve_loop import Server

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64, vocab_pad=64, head_dim=16)
MAX_LEN = 32
# Logits rows of the two engines agree within this share of their range:
# the int8 codes and accumulators are equal, only float32 last places
# differ (measured: at most 4.3e-7).
ROW_RTOL = 1e-5
JAX_BACKENDS = ("bf16", "int8_exact", "approx_lut", "approx_stage1", "msr4",
                "approx_deficit_pallas", "approx_stage1_pallas",
                "approx_rank1_pallas")
BACKENDS = ("bf16",) + QM.list_backends()


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


def _ref_backend(name):
    if name == "bf16":
        return name
    return RQM.get_backend(name).oracle or name


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab"], n).astype(np.int32) for n in lens]


def _shared_prompts(seed, suffixes=(4, 3, 5)):
    """Prompts sharing an 8-token prefix (2 pages at page_size=4)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, TINY["vocab"], 8).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, TINY["vocab"], n)
                            .astype(np.int32)]) for n in suffixes]


def _serve(cfg, reqs, *, slots=2, **kw):
    eng = Engine(cfg, _tiny()[3], slots=slots, max_len=kw.pop(
        "max_len", MAX_LEN), device="cpu", **kw)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return {r.rid: r for r in eng.completed}, stats, eng


def _oracle(cfg, prompt, max_new):
    """Hand-rolled single-request greedy decode: exact-length prefill,
    scalar positions."""
    params = _tiny()[3]
    caches = PT.init_cache(cfg, 1, MAX_LEN, torch.float32, device="cpu")
    logits, caches = PT.prefill(params, torch.from_numpy(prompt[None]), cfg,
                                caches)
    out = [int(np.argmax(logits[0, -1].numpy()))]
    pos = len(prompt)
    while len(out) < max_new and pos < MAX_LEN:
        logits, caches = PT.decode_step(
            params, torch.tensor([[out[-1]]]), pos, cfg, caches)
        out.append(int(np.argmax(logits[0, -1].numpy())))
        pos += 1
    return out


# ---------------------------------------------------------------------------
# The engine against the JAX package's
# ---------------------------------------------------------------------------

_workload = REFS.workload
_recorded_serve = REFS.recorded_serve
_jax_served = REFS.jax_served


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_greedy_tokens_equal_the_reference_engine(backend):
    want, want_rows, want_stats = _jax_served(_ref_backend(backend))
    got, rows, stats = _recorded_serve(
        PE, Engine(_cfg(backend), _tiny()[3], slots=2, max_len=MAX_LEN,
                   page_size=4, device="cpu"))
    assert stats["waves"] >= 2 and stats["prefix_hit_tokens"] > 0
    for key in ("prefix_hit_tokens", "prefill_tokens", "decode_steps",
                "waves", "new_tokens", "finish_reasons"):
        assert stats[key] == want_stats[key], key
    assert rows.keys() == want_rows.keys()
    for key, want_row in want_rows.items():
        span = float(np.ptp(want_row))
        top2 = np.sort(want_row)[-2:]
        assert top2[1] - top2[0] > 2 * ROW_RTOL * span, \
            f"{backend} {key}: near-tie, the comparison would be luck"
        np.testing.assert_allclose(rows[key], want_row, rtol=0,
                                   atol=ROW_RTOL * span,
                                   err_msg=f"{backend} (rid, step) {key}")
    assert got == want


# ---------------------------------------------------------------------------
# The engine's own invariances, per backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_tokens_invariant_to_batching_admission_and_prefix_cache(backend):
    """Alone == full batch == admitted mid-decode into a reused slot on a
    prefix-cache hit == cold with the prefix cache off == the hand-rolled
    greedy decode."""
    cfg = _cfg(backend)
    p0, p1, probe = _shared_prompts(seed=22)

    def req(rid, p, m):
        return ServeRequest(rid=rid, prompt=p, max_new=m)

    alone, stats, _ = _serve(cfg, [req(9, probe, 4)], page_size=4)
    assert stats["prefix_hit_tokens"] == 0          # the cold miss
    full, _, _ = _serve(cfg, [req(0, p0, 3), req(9, probe, 4)], page_size=4)
    mid, stats, _ = _serve(cfg, [req(0, p0, 2), req(1, p1, 6),
                                 req(9, probe, 4)], page_size=4)
    assert stats["waves"] >= 2, "probe was not admitted mid-decode"
    assert stats["prefix_hit_tokens"] >= 8, "probe admission missed the cache"
    off, _, _ = _serve(cfg, [req(9, probe, 4)], prefix_caching=False)
    a, b, c, d = (r[9].output for r in (alone, full, mid, off))
    assert a == b == c == d, (f"{backend}: alone={a} full={b} mid/hit={c} "
                              f"unpaged={d}")
    assert a == _oracle(cfg, probe, 4)


def test_finish_reasons():
    cfg = _cfg("bf16")
    prompt = _prompts([4], seed=1)[0]
    done, _, _ = _serve(cfg, [ServeRequest(rid=0, prompt=prompt, max_new=3)])
    assert len(done[0].output) == 3 and done[0].finish_reason == "max_new"
    # a prompt of plen emits at most max_len - plen + 1 tokens, and says so
    long = _prompts([10], seed=2)[0]
    done, _, _ = _serve(cfg, [ServeRequest(rid=1, prompt=long, max_new=10)],
                        max_len=12)
    assert len(done[1].output) == 3 and done[1].finish_reason == "max_len"
    done, _, _ = _serve(cfg, [ServeRequest(rid=2, prompt=_prompts(
        [13], seed=3)[0], max_new=4)], max_len=12)
    assert done[2].output == [] and done[2].finish_reason == "max_len"
    base, _, _ = _serve(cfg, [ServeRequest(rid=0, prompt=prompt, max_new=8)])
    toks = base[0].output
    eos = toks[1]
    done, _, _ = _serve(cfg, [ServeRequest(rid=0, prompt=prompt, max_new=8)],
                        eos_id=eos)
    assert done[0].finish_reason == "eos"
    assert done[0].output == toks[:toks.index(eos) + 1]
    assert set(FINISH_REASONS) == {"eos", "max_new", "max_len"}


def test_slot_reuse_leaks_no_kv():
    cfg = _cfg("int8_exact")
    p1, p2 = _prompts([7, 4], seed=6)
    both, _, _ = _serve(cfg, [ServeRequest(rid=0, prompt=p1, max_new=3),
                              ServeRequest(rid=1, prompt=p2, max_new=5)],
                        slots=1, prefix_caching=False)
    solo, _, _ = _serve(cfg, [ServeRequest(rid=1, prompt=p2, max_new=5)],
                        slots=1, prefix_caching=False)
    assert both[1].output == solo[1].output
    # paged: published pages come from each request's own KV
    pa, pb, pc = _shared_prompts(seed=23)
    done, _, _ = _serve(cfg, [ServeRequest(rid=i, prompt=p, max_new=3)
                              for i, p in enumerate((pa, pb, pc))],
                        slots=1, page_size=4)
    for rid, p in ((1, pb), (2, pc)):
        solo, _, _ = _serve(cfg, [ServeRequest(rid=rid, prompt=p,
                                               max_new=3)],
                            slots=1, prefix_caching=False)
        assert done[rid].output == solo[rid].output


def test_resubmitted_request_starts_fresh():
    cfg = _cfg("bf16")
    req = ServeRequest(rid=0, prompt=_prompts([4], seed=10)[0], max_new=3)
    first, _, _ = _serve(cfg, [req], slots=1)
    toks = list(first[0].output)
    second, _, _ = _serve(cfg, [req], slots=1)
    assert second[0].output == toks and second[0].finish_reason == "max_new"


def test_engine_stats_are_sane():
    cfg = _cfg("bf16")
    reqs = [ServeRequest(rid=i, prompt=p, max_new=4)
            for i, p in enumerate(_prompts([3, 5, 4, 6, 2], seed=9))]
    done, stats, _ = _serve(cfg, reqs)
    assert stats["requests"] == 5 and stats["prefills"] == 5
    assert stats["new_tokens"] == sum(len(r.output) for r in done.values())
    assert 0.0 < stats["occupancy"] <= 1.0 and stats["tok_per_s"] > 0
    assert stats["waves"] >= 2
    for r in done.values():
        assert r.finish_reason in FINISH_REASONS
        assert r.timing.ttft_s is not None and r.timing.ttft_s >= 0
        assert r.timing.total_s >= r.timing.ttft_s


def test_drain_server_serves_the_engine_tokens():
    """``train/serve_loop.Server``: the engine under the 'drain' policy
    (admit a full wave, decode it out, then the next) serves the tokens of
    continuous batching, and counts its waves as ``batches``."""
    cfg = _cfg("int8_exact")

    def reqs():
        return [ServeRequest(rid=i, prompt=p, max_new=m) for i, (p, m) in
                enumerate(zip(_prompts([3, 5, 4], seed=12), (4, 2, 3)))]

    cont, _, _ = _serve(cfg, reqs())
    srv = Server(cfg, _tiny()[3], batch_slots=2, max_len=MAX_LEN,
                 device="cpu")
    for r in reqs():
        srv.submit(r)
    stats = srv.run()
    assert {r.rid: r.output for r in srv.completed} == \
        {rid: r.output for rid, r in cont.items()}
    assert stats["batches"] == stats["waves"] == 2
    assert srv.engine.sched.policy == "drain"


def test_engine_rejects_what_it_does_not_run():
    cfg, params = _cfg("bf16"), _tiny()[3]
    eng = Engine(cfg, params, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(ServeRequest(rid=0, prompt=np.zeros(0, np.int32)))
    # a mesh of one position serves unsharded; a larger one must be a
    # DeviceMesh of ranks (tests/test_torch_serve_mesh.py serves over one)
    assert Engine(cfg, params, slots=1, max_len=8, device="cpu",
                  mesh=make_host_mesh()).mesh is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(cfg, params, mesh=MeshLayout(("data", "model"), (2, 2)),
               device="cpu")
    with pytest.raises(ValueError, match="position-indexed"):
        Engine(dataclasses.replace(cfg, local_window=8), params,
               spec=SpecConfig(k=4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(cfg, params)                  # the card by default
    assert Engine(cfg, params, slots=1, max_len=4, page_size=8,
                  device="cpu").prefix is None
    assert Engine(cfg, params, slots=1, max_len=16, prefix_caching=False,
                  device="cpu").prefix is None
    assert padded_prefill_ok(cfg)
    assert not padded_prefill_ok(dataclasses.replace(cfg, local_window=8,
                                                     local_ratio=5))


def test_sampled_requests_are_batching_invariant():
    cfg = _cfg("approx_lut")
    scfg = SamplingConfig(kind="top_k", temperature=0.9, top_k=8, seed=7)
    p0, p1 = _prompts([3, 5], seed=7)
    alone, _, _ = _serve(cfg, [ServeRequest(rid=1, prompt=p1, max_new=6,
                                            sampling=scfg)])
    both, _, _ = _serve(cfg, [ServeRequest(rid=0, prompt=p0, max_new=4,
                                           sampling=scfg),
                              ServeRequest(rid=1, prompt=p1, max_new=6,
                                           sampling=scfg)])
    assert alone[1].output == both[1].output


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def test_greedy_takes_the_first_maximum():
    row = np.array([0.5, 2.0, -1.0, 2.0], np.float32)
    assert sample_token(row, SamplingConfig(), rid=0, step=0) == 1
    assert sample_token(torch.from_numpy(row), SamplingConfig(), 0, 0) == 1


def test_draws_are_keyed_by_seed_rid_and_step_only():
    """The invariance signature of the reference's ``stream_key``. The
    streams themselves differ from the JAX package's (another PRNG): only
    determinism and the keying are claimed."""
    rng = np.random.default_rng(0)
    row = rng.normal(size=64).astype(np.float32)
    scfg = SamplingConfig(kind="temperature", temperature=1.5, seed=3)
    draws = [sample_token(row, scfg, rid=2, step=s) for s in range(40)]
    assert draws == [sample_token(row, scfg, rid=2, step=s)
                     for s in range(40)]
    assert len(set(draws)) > 1
    other = [sample_token(row, dataclasses.replace(scfg, seed=4), 2, s)
             for s in range(40)]
    assert other != draws
    g1 = PS.stream_generator(3, 2, 5)
    g2 = PS.stream_generator(3, 2, 5)
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))


def test_top_k_samples_at_most_k_candidates():
    row = np.array([5.0, 5.0, 5.0, 1.0, 0.0, 5.0], np.float32)
    scfg = SamplingConfig(kind="top_k", temperature=1.0, top_k=2, seed=1)
    seen = {sample_token(row, scfg, 0, s) for s in range(200)}
    assert seen == {0, 1}          # ties at the k-th value: index order
    with pytest.raises(ValueError, match="top_k >= 1"):
        sample_token(row, SamplingConfig(kind="top_k", top_k=0), 0, 0)


def test_sampling_rejects_bad_configs():
    with pytest.raises(ValueError, match="temperature > 0"):
        SamplingConfig(kind="temperature", temperature=0.0)
    with pytest.raises(ValueError, match="unknown sampling kind"):
        sample_token(np.zeros(4), SamplingConfig(kind="beam"), 0, 0)


def test_padded_vocab_is_never_sampled():
    row = np.full(16, np.finfo(np.float32).min, np.float32)
    row[:4] = [0.1, 0.2, 0.3, 0.4]
    scfg = SamplingConfig(kind="temperature", temperature=0.5, seed=2)
    assert {sample_token(row, scfg, 0, s) for s in range(100)} <= {0, 1, 2,
                                                                    3}


# ---------------------------------------------------------------------------
# The copied scheduler and paging: the reference's property cases
# ---------------------------------------------------------------------------

def _simulate(cls, steps_list, n_slots, policy="continuous", late_split=0):
    """Drive a scheduler class with a fake decode loop (the reference's
    property harness): each item needs ``steps`` decode steps. Returns
    (admit_order, done_order, max_running, drain_violations, sched)."""
    sched = cls(n_slots, policy)
    items = [{"rid": i, "left": s} for i, s in enumerate(steps_list)]
    cut = len(items) - late_split
    early, late = items[:cut], items[cut:]
    for it in early:
        sched.submit(it)
    admit_order, done = [], []
    max_running = drain_violations = guard = 0
    while not sched.idle or late:
        guard += 1
        assert guard < 10_000, "scheduler livelocked"
        if guard == 3 and late:          # mid-run arrivals
            for it in late:
                sched.submit(it)
            late = []
        before = sched.running
        batch = sched.admit()
        if batch and policy == "drain" and before > 0:
            drain_violations += 1
        admit_order.extend(it["rid"] for _, it in batch)
        max_running = max(max_running, sched.running)
        for slot in sorted(sched.occupied()):
            it = sched.item(slot)
            it["left"] -= 1
            if it["left"] <= 0:
                done.append(sched.release(slot)["rid"])
    return admit_order, done, max_running, drain_violations, sched


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(1, 9), min_size=1, max_size=24),
       st.integers(1, 5), st.integers(0, 5))
def test_scheduler_properties_and_reference_trace(steps, n_slots, late):
    late = min(late, len(steps) - 1)
    for policy in ("continuous", "drain"):
        got = _simulate(SlotScheduler, steps, n_slots, policy, late)
        want = _simulate(RS.SlotScheduler, steps, n_slots, policy, late)
        admit_order, done, max_running, violations, sched = got
        assert got[:4] == want[:4]
        assert sorted(done) == list(range(len(steps)))
        assert sched.submitted == sched.completed == len(steps)
        assert max_running <= n_slots
        assert admit_order == list(range(len(steps)))
        assert violations == 0
        assert sched.waves == want[4].waves


def test_scheduler_rejects_bad_args():
    with pytest.raises(ValueError, match="policy"):
        SlotScheduler(2, "round_robin")
    with pytest.raises(ValueError, match="n_slots"):
        SlotScheduler(0)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 2), min_size=1, max_size=60),
       st.integers(1, 8))
def test_page_pool_conserves_pages(ops, n_pages):
    pool, ref = PagePool(n_pages), RPG.PagePool(n_pages)
    held = []                     # one entry per reference we hold
    for op in ops:
        if op == 0:
            p = pool.alloc()
            assert p == ref.alloc()
            if p is not None:
                assert p not in held, "alloc handed out a live page"
                held.append(p)
        elif op == 1 and held:
            pool.incref(held[0])
            ref.incref(held[0])
            held.append(held[0])
        elif op == 2 and held:
            p = held.pop()
            pool.decref(p)
            ref.decref(p)
        live = pool.live
        assert pool.n_free + len(live) == n_pages
        assert sorted(set(held)) == live == ref.live
        for p in set(held):
            assert pool.refcount(p) == held.count(p)


def test_page_pool_rejects_use_of_free_pages():
    pool = PagePool(2)
    p = pool.alloc()
    pool.decref(p)
    with pytest.raises(RuntimeError, match="decref on free"):
        pool.decref(p)
    with pytest.raises(RuntimeError, match="incref on free"):
        pool.incref(p)
    with pytest.raises(ValueError, match="n_pages"):
        PagePool(0)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.lists(st.integers(0, 3), min_size=1, max_size=12),
                min_size=1, max_size=8),
       st.integers(1, 3))
def test_prefix_cache_no_aliasing_and_reference_trace(seqs, page_size):
    cache, ref = PrefixCache(page_size, 16), RPG.PrefixCache(page_size, 16)
    for seq in seqs:
        chain = cache.match(seq)
        assert chain == ref.match(seq)
        assert len(chain) * page_size <= len(seq)
        cache.acquire(chain)
        ref.acquire(chain)
        assert cache.insert(seq) == ref.insert(seq)
        cache.release(chain)
        ref.release(chain)
        pages = cache.pages()
        assert pages == ref.pages()
        assert len(pages) == len(set(pages)), "page aliased between nodes"
        assert len(pages) + cache.pool.n_free == 16, "page leaked"
        assert all(cache.pool.refcount(p) == 1 for p in pages)
    assert cache.stats() == ref.stats()


def test_prefix_cache_longest_match_and_eviction():
    cache = PrefixCache(2, 8)
    cache.insert([1, 2, 3, 4, 5, 6])
    assert len(cache.match([1, 2, 3, 4, 9, 9])) == 2
    assert len(cache.match([1, 2, 3])) == 1            # partial page: no
    assert cache.match([9, 9]) == []
    cache = PrefixCache(1, 4)
    cache.insert([1, 2])
    chain = cache.match([1, 2])
    cache.acquire(chain)              # a live request pins the chain
    assert len(cache.insert([7, 8, 9])) == 2
    assert cache.match([1, 2]) == chain, "pinned chain was evicted"
    cache.release(chain)
    assert len(cache.insert([5, 5, 5])) == 3
    assert cache.evictions >= 3
    assert len(cache.pages()) + cache.pool.n_free == 4


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_cli_serves_the_reduced_config_on_the_cpu(capsys):
    stats = CLI.main(["--device", "cpu", "--reduced", "--requests", "4",
                      "--slots", "2", "--max-new", "4",
                      "--shared-prefix", "8"])
    out = capsys.readouterr().out
    assert stats["requests"] == 4 and stats["new_tokens"] > 0
    assert "smollm-135m: 4 layers, d_model 128" in out and "on cpu" in out
    assert stats["prefix_hit_tokens"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CLI.main(["--reduced"])              # the card by default

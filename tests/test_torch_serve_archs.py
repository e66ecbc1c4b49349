"""The serving engine over the windowed, MLA and mixture-of-experts archs
(gemma3-27b, deepseek-v2-236b, kimi-k2-1t-a32b) and the SSM archs
(rwkv6-3b, hymba-1.5b) at ``registry.reduced``'s size, against the JAX
package's engine (the SSM archs: its prefill / decode_step) and against
its own invariances.

Weights are the JAX package's ``TLM.init`` at key 0 carried across by
``repro_torch.convert``; where the port runs a ``*_pallas`` backend (on the
CPU, its kernels' plain versions) the JAX engine runs its oracle.

What is claimed, at the token level:
  * gemma3 serves unpaged (no prefix cache) and prefills every prompt at
    its exact length, decodes past its 8-slot rings, and refuses
    speculation (a ring cannot roll back);
  * deepseek-v2 (MLA, position-indexed) serves paged: prompts on a
    prefix-cache hit get the tokens of cold misses, and speculative
    serving the tokens of sequential decode;
  * greedy tokens equal the JAX engine's, one backend per family: bf16
    for gemma3, whose logits rows agree within 1e-6 there, and
    approx_deficit_pallas for deepseek-v2. Under a quantized
    backend gemma3's tokens are not claimed equal to the JAX engine's:
    torch's gelu rounds otherwise than XLA's in the last place, a last
    place at a rounding boundary flips an int8 code, and the reduced
    model's flat logits follow (measured on this workload: under
    approx_stage1 request 3's prefill row differs by 1.0e-2 against a
    top-2 gap of 1.9e-3, and its first token differs).
The SSM archs serve unpaged at exact prompt lengths, as gemma3 does: a
request's tokens equal those of the request alone and the JAX package's,
under bf16 and approx_stage1_pallas (on this workload the quantized tokens
agree too); admission overwrites a slot's whole state. The MoE archs'
tokens are held, not their logits rows: a mixture-of-
experts layer sets its capacity per call group (``nn/moe.py``), so a
suffix prefill on a prefix hit may drop other entries than a cold prefill
does. The port's verify pass routes each column alone, as sequential
decode does (``models/transformer_lm.verify_step``).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.models import transformer_lm as RT
from repro.quant import matmul as RQM
from repro.serve import engine as RE

import repro_torch.serve as PS
from repro_torch.models import transformer_lm as PT
from repro_torch.quant.quantize import for_lm
from repro_torch.serve import Engine, SpecConfig
from repro_torch.serve import __main__ as CLI

from test_torch_archs import _arch    # the same weights, drawn once

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

MAX_LEN = 32
STAGE1 = SpecConfig(k=4, draft_backend="approx_stage1")


def _reqs(arch: str, module=None, seed=3, n=4):
    """More requests than the 2-slot pool. gemma3: prompts of 6 tokens
    (within the window of 8) and 10-14 new tokens, so that decode wraps
    the rings; the MoE archs: an 8-token shared prefix (one page) and
    2-7 tokens of their own, so that later requests hit the prefix
    cache."""
    make = (module or RE).ServeRequest
    rng = np.random.default_rng(seed)
    vocab = RR.reduced(arch).vocab
    if arch == "gemma3-27b":
        news = rng.integers(10, 15, n)
        return [make(rid=r, prompt=rng.integers(0, vocab, 6).astype(np.int32),
                     max_new=int(news[r])) for r in range(n)]
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    lens, news = rng.integers(2, 8, n), rng.integers(4, 10, n)
    return [make(rid=r, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, int(lens[r])).astype(np.int32)]),
        max_new=int(news[r])) for r in range(n)]


def _serve(arch, backend, reqs, **kw):
    cfg = dataclasses.replace(_arch(arch)[1], quant=for_lm(backend))
    eng = Engine(cfg, _arch(arch)[3], slots=2, max_len=MAX_LEN,
                 device="cpu", **kw)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return {r.rid: list(r.output) for r in eng.completed}, stats, eng


def test_gemma_serves_unpaged_at_exact_prompt_lengths():
    """No prefix cache; each prefill is the prompt's exact length (no
    bucket padding, which a ring would alias onto real positions); the
    pool's local caches are 8-slot rings that the decode wraps; tokens
    equal those of a single-request engine (row isolation)."""
    reqs = _reqs("gemma3-27b", module=PS)
    cfg = dataclasses.replace(_arch("gemma3-27b")[1],
                              quant=for_lm("approx_stage1_pallas"))
    eng = Engine(cfg, _arch("gemma3-27b")[3], slots=2, max_len=MAX_LEN,
                 device="cpu")
    assert eng.prefix is None
    assert eng.pool["blocks"][0]["k0_local"]["k"].shape[2] == 8
    widths = []
    inner = eng._prefill

    def spy(p, toks, c, lengths, off):
        widths.append(toks.shape[1])
        return inner(p, toks, c, lengths, off)

    eng._prefill = spy
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    assert widths == [6] * len(reqs)
    assert stats["waves"] >= 2
    got = {r.rid: list(r.output) for r in eng.completed}
    assert max(6 + len(t) for t in got.values()) > 8 + 8, "no ring wrap"
    for r in _reqs("gemma3-27b", module=PS)[:1]:
        alone, _, _ = _serve("gemma3-27b", "approx_stage1_pallas", [r])
        assert alone[r.rid] == got[r.rid]


def test_gemma_refuses_speculation():
    with pytest.raises(ValueError, match="position-indexed"):
        _serve("gemma3-27b", "bf16", [], spec=STAGE1)


@pytest.mark.parametrize("backend", ["bf16", "approx_stage1_pallas"])
def test_deepseek_prefix_hits_equal_cold_misses(backend):
    """Paged MLA caches: the shared prefix is served from the page store
    (hit rate > 0) and every request's tokens equal the prefix-cache-off
    serving's."""
    hit, stats, eng = _serve("deepseek-v2-236b", backend,
                             _reqs("deepseek-v2-236b", module=PS))
    assert eng.prefix is not None and stats["prefix_hit_rate"] > 0
    cold, cold_stats, _ = _serve("deepseek-v2-236b", backend,
                                 _reqs("deepseek-v2-236b", module=PS),
                                 prefix_caching=False)
    assert cold_stats["prefix_hit_rate"] == 0
    assert hit == cold


@pytest.mark.parametrize("backend", ["bf16", "approx_deficit_pallas"])
def test_deepseek_spec_equals_sequential(backend):
    """K = 4 speculation with the approx_stage1 draft gives sequential
    decode's tokens; drafts are accepted."""
    seq, _, _ = _serve("deepseek-v2-236b", backend,
                       _reqs("deepseek-v2-236b", module=PS, seed=5))
    spc, stats, _ = _serve("deepseek-v2-236b", backend,
                           _reqs("deepseek-v2-236b", module=PS, seed=5),
                           spec=STAGE1)
    assert spc == seq
    assert stats["spec_passes"] > 0
    assert stats["spec_committed"] > stats["spec_passes"]


@pytest.mark.parametrize("backend", ["int8_exact", "approx_stage1_pallas"])
def test_deepseek_verify_rows_equal_sequential_decode(backend):
    """verify_step over a K = 4 window (MLA attention and the experts run
    per column, as in decode) gives the four sequential decode steps'
    logits rows and cache writes bit for bit."""
    cfg = dataclasses.replace(_arch("deepseek-v2-236b")[1],
                              quant=for_lm(backend))
    params = _arch("deepseek-v2-236b")[3]
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 5)))
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
        assert torch.equal(vlg[:, j], seq[j]), f"verify row {j}"
    leaves = ([], [])
    for out, tree in zip(leaves, (vcache, cache)):
        PT.map_leaves(out.append, tree)
    assert all(torch.equal(a, b) for a, b in zip(*leaves))


@pytest.mark.parametrize("arch,backend", [
    ("gemma3-27b", "bf16"),
    ("deepseek-v2-236b", "approx_deficit_pallas")])
def test_greedy_tokens_equal_the_reference_engine(arch, backend):
    """The same workload through the JAX package's engine (the backend's
    oracle) and the port's, for each family (gemma3's dense windowed
    stack; deepseek-v2's MLA and mixture of experts, whose MoE layer
    kimi-k2 shares): equal greedy tokens, prefix-cache hits, admission
    waves and decode steps."""
    rcfg, _, rparams, _ = _arch(arch)
    oracle = backend if backend == "bf16" else \
        RQM.get_backend(backend).oracle
    ref = RE.Engine(dataclasses.replace(rcfg, quant=RQ.for_lm(oracle)),
                    rparams, slots=2, max_len=MAX_LEN)
    for r in _reqs(arch):
        ref.submit(r)
    want_stats = ref.run()
    want = {r.rid: list(r.output) for r in ref.completed}
    got, stats, _ = _serve(arch, backend, _reqs(arch, module=PS))
    assert got == want
    for key in ("prefix_hit_rate", "waves", "decode_steps"):
        assert stats[key] == want_stats[key], key


# ---------------------------------------------------------------------------
# The SSM archs: rwkv6 (recurrent state only) and hymba (a ring of 8 beside
# the Mamba state)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("rwkv6-3b", "hymba-1.5b")
SSM_PROMPT = 6                   # within hymba's reduced window of 8; a
#                                  padded prefill would take 8
SSM_NEW = (6, 3, 5, 4)           # rid 1 retires first: rid 2 reuses its slot


def _ssm_reqs(arch: str):
    rng = np.random.default_rng(11)
    vocab = RR.reduced(arch).vocab
    return [PS.ServeRequest(rid=r, prompt=rng.integers(
        0, vocab, SSM_PROMPT).astype(np.int32), max_new=m)
        for r, m in enumerate(SSM_NEW)]


def _port_alone(cfg, params, req) -> list:
    """Greedy tokens of one request through the port's prefill and
    decode_step on a batch-1 cache."""
    with torch.no_grad():
        cache = PT.init_cache(cfg, 1, MAX_LEN, torch.float32, "cpu")
        lg, cache = PT.prefill(params, torch.from_numpy(req.prompt)[None]
                               .long(), cfg, cache)
        toks = [int(lg[0, -1].argmax())]
        for j in range(req.max_new - 1):
            lg, cache = PT.decode_step(params, torch.tensor([[toks[-1]]]),
                                       len(req.prompt) + j, cfg, cache)
            toks.append(int(lg[0, -1].argmax()))
    return toks


def _jax_greedy(arch, backend, reqs) -> dict:
    """The requests' greedy tokens through the JAX package's prefill and
    decode_step (the backend's oracle), all rows in one batch: the prompts
    share a length, and each row of an SSM's or a ring's cache is its
    own. Two compiles (prefill, decode) per arch and backend."""
    rcfg, _, rparams, _ = _arch(arch)
    oracle = backend if backend == "bf16" else \
        RQM.get_backend(backend).oracle
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(oracle))
    cache = RT.init_cache(cfg, len(reqs), MAX_LEN, jnp.float32)
    lg, cache = jax.jit(lambda p, t, c: RT.prefill(p, t, cfg, c))(
        rparams, jnp.asarray(np.stack([r.prompt for r in reqs])), cache)
    dec = jax.jit(lambda p, t, pos, c: RT.decode_step(p, t, pos, cfg, c))
    toks = [jnp.argmax(lg[:, -1], -1)]
    for j in range(max(r.max_new for r in reqs) - 1):
        lg, cache = dec(rparams, toks[-1][:, None],
                        jnp.int32(SSM_PROMPT + j), cache)
        toks.append(jnp.argmax(lg[:, -1], -1))
    toks = np.stack([np.asarray(t) for t in toks], 1)
    return {r.rid: toks[i, :r.max_new].tolist() for i, r in enumerate(reqs)}


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("backend", ["bf16", "approx_stage1_pallas"])
def test_ssm_serving_equals_each_request_alone(arch, backend):
    """4 requests into 2 slots (one admitted into a freed slot whose state
    the parked decode steps filled with junk), unpaged, each prefilled at
    its exact prompt length: every request's tokens equal that request
    served alone by the port's prefill + decode_step, and the JAX
    package's prefill / decode_step tokens on the same weights."""
    cfg = dataclasses.replace(_arch(arch)[1], quant=for_lm(backend))
    eng = Engine(cfg, _arch(arch)[3], slots=2, max_len=MAX_LEN,
                 device="cpu")
    assert eng.prefix is None and not PS.engine.padded_prefill_ok(cfg)
    widths = []
    inner = eng._prefill

    def spy(p, toks, c, lengths, off):
        widths.append(toks.shape[1])
        return inner(p, toks, c, lengths, off)

    eng._prefill = spy
    for r in _ssm_reqs(arch):
        eng.submit(r)
    stats = eng.run()
    assert widths == [SSM_PROMPT] * len(SSM_NEW)
    assert stats["waves"] >= 2
    got = {r.rid: list(r.output) for r in eng.completed}
    for r in _ssm_reqs(arch):
        assert got[r.rid] == _port_alone(cfg, _arch(arch)[3], r), r.rid
    assert got == _jax_greedy(arch, backend, _ssm_reqs(arch))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_admission_overwrites_the_whole_state(arch):
    """write_slot copies every leaf of a fresh batch-1 cache over the
    pool's row, the float32 SSM states (and hymba's ring) included, and
    touches no other row."""
    cfg = _arch(arch)[1]
    pool = PT.map_leaves(lambda t: t.fill_(7.0),
                         PT.init_cache(cfg, 3, MAX_LEN, torch.float32, "cpu"))
    fresh = PT.init_cache(cfg, 1, MAX_LEN, torch.float32, "cpu")
    PT.map_leaves(lambda t: t.normal_(), fresh)
    PT.write_slot(pool, fresh, 1)
    leaves = []
    PT.map_leaves(lambda p, f: leaves.append((p, f)), pool, fresh)
    assert len(leaves) == (3 if arch == "rwkv6-3b" else 4)
    for p, f in leaves:
        assert torch.equal(p[:, 1], f[:, 0])
        assert bool((p[:, [0, 2]] == 7.0).all())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_refuses_speculation_and_long_hymba_prompts(arch):
    """An SSM state cannot roll back rejected positions: speculation is
    refused at construction. hymba's attention is a ring of 8 slots at
    max_len 32: a 9-token prompt is refused at submit; rwkv6 takes it."""
    with pytest.raises(ValueError, match="position-indexed"):
        _serve(arch, "bf16", [], spec=STAGE1)
    cfg, params = _arch(arch)[1], _arch(arch)[3]
    eng = Engine(cfg, params, slots=1, max_len=MAX_LEN, device="cpu")
    prompt = np.arange(9, dtype=np.int32)
    if arch == "hymba-1.5b":
        assert PT.prefill_limit(cfg, MAX_LEN) == 8
        with pytest.raises(ValueError, match="8-slot ring buffer"):
            eng.submit(PS.ServeRequest(rid=0, prompt=prompt))
    else:
        assert PT.prefill_limit(cfg, MAX_LEN) is None
        eng.submit(PS.ServeRequest(rid=0, prompt=prompt, max_new=2))
        eng.run()
        assert len(eng.completed[0].output) == 2


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_cli_serves_the_reduced_config(capsys, arch):
    """``python -m repro_torch.serve --arch ... --reduced --device cpu``
    serves the SSM archs (hymba's prompts capped at its window)."""
    stats = CLI.main(["--arch", arch, "--device", "cpu", "--reduced",
                      "--requests", "3", "--slots", "2", "--max-new", "3"])
    assert stats["requests"] == 3 and stats["new_tokens"] > 0
    assert f"{arch}: 4 layers, d_model 128" in capsys.readouterr().out

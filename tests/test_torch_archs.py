"""The port's windowed ring-buffer attention, MLA, mixture-of-experts layer
and the archs that use them (gemma3-27b, deepseek-v2-236b,
kimi-k2-1t-a32b), and the SSM archs (rwkv6-3b, hymba-1.5b; their mixers are
held in ``tests/test_torch_ssm.py``), against the JAX package's, on the
same numpy inputs.

The archs are ``registry.reduced``'s (d_model 128, a window of 8 over one
whole 5:1 gemma3 group and over hymba's attention, 8 experts top-2 with
one shared, a 32-wide MLA latent, rwkv6's chunked WKV); their weights are
the JAX package's ``TLM.init`` at key 0, carried across by
``repro_torch.convert``. Where the port runs a backend with an
oracle, the JAX side runs the oracle (``approx_lut`` for
``approx_deficit_pallas``): the JAX package's own tests hold its Pallas
entries to their oracles bit for bit, and its interpret mode takes minutes
at these sizes. On the CPU the port's ``*_pallas`` backends run their
kernels' plain versions.

What is claimed, and within what:
  * int8 codes and int32 accumulators of every quantized projection are
    equal bit for bit, given the same input rows (the port's own inputs,
    recorded during its forward);
  * MoE expert ids, capacity ``keep`` masks and buffer slots are equal;
  * float outputs: one layer within FLOAT_RTOL of its range; logits and
    losses under bf16 within FLOAT_RTOL; under a quantized backend within
    QUANT_RTOL, because the two stacks' activations differ in float last
    places (torch's gelu and silu round otherwise than XLA's in about a
    quarter of all elements), and a last place at a rounding boundary moves
    a later layer's int8 code by one step (measured: 7.7e-3 of the logits'
    range on the reduced gemma3 under approx_lut);
  * MLA is held ``allclose`` as the reference holds itself: XLA reassociates
    the absorbed einsums (``tests/test_serve.py`` of the JAX package).
A prefill longer than a ring is refused with ``ValueError``: the
reference's scatter of such a prompt writes one slot twice in one update,
an order XLA leaves undefined (ROADMAP queue C).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import transformer_lm as RT
from repro.nn import attention as RA
from repro.nn import moe as RMOE
from repro.parallel.sharding import DEFAULT_RULES
from repro.quant import matmul as RQM

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer_lm as PT
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import module as M
from repro_torch.nn import moe as MOE
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig, for_lm, quantize_dynamic
from repro_torch.serve import Engine, ServeRequest

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

ARCHS = ("gemma3-27b", "deepseek-v2-236b", "kimi-k2-1t-a32b", "rwkv6-3b",
         "hymba-1.5b")
BACKENDS = ("bf16", "approx_lut", "approx_deficit_pallas")
FLOAT_RTOL = 1e-5
QUANT_RTOL = 2e-2
MLA_RTOL, MLA_ATOL = 1e-4, 1e-5
RNG = np.random.default_rng(17)


def _ref_backend(name: str) -> str:
    if name == "bf16":
        return name
    return RQM.get_backend(name).oracle or name


def _close(got, want, rtol):
    """|got - want| <= rtol * the range of ``want`` (at least 1)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    bound = rtol * max(1.0, float(np.ptp(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _arch(name: str):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced arch."""
    rcfg, pcfg = RR.reduced(name), PR.reduced(name)
    rparams = jax.jit(RT.init, static_argnums=0)(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams),
                              device="cpu")
    return rcfg, pcfg, rparams, pparams


def _layer_params(name: str, key: str):
    """Layer 0's ``key`` subtree of block group 0, on both sides."""
    rcfg, _, rparams, pparams = _arch(name)
    kind = rcfg.blocks()[0][1]
    layer = next(f"k{i}_{k}" for i, k in enumerate(kind)
                 if key != "local" or k == "local")
    sub = "moe" if key == "moe" else "attn"
    rp = jax.tree.map(lambda t: t[0], rparams["blocks"][0])[layer][sub]
    pp = PT.map_leaves(lambda t: t[0], pparams["blocks"][0])[layer][sub]
    return rp, pp


# ---------------------------------------------------------------------------
# Windowed ring-buffer attention (gemma3's local layers)
# ---------------------------------------------------------------------------

RING_MAX_LEN = 16      # > the window of 8: the local cache is a ring


@pytest.mark.parametrize("backend", ["bf16", "int8_exact"])
def test_windowed_ring_apply_matches_reference(backend):
    """A 6-token prefill into an 8-slot ring, then ten vector-position
    decode steps (rows at depths 6 and 4) that wrap it: every output and
    the ring's contents agree with the JAX package's."""
    rcfg, pcfg = _arch("gemma3-27b")[:2]
    racfg, acfg = rcfg.attn_cfg("local"), pcfg.attn_cfg("local")
    rp, pp = _layer_params("gemma3-27b", "local")
    rq, pq = RQ.for_lm(backend), for_lm(backend)
    rc = RA.init_cache(racfg, 2, RING_MAX_LEN, jnp.float32)
    pc = A.init_cache(acfg, 2, RING_MAX_LEN, torch.float32)
    assert pc["k"].shape[1] == acfg.window == 8
    ref = jax.jit(lambda x, c, pos: RA.apply(
        rp, x, racfg, DEFAULT_RULES, rq, cache=c, pos=pos))
    x = RNG.normal(size=(2, 6, 128)).astype(np.float32)
    want, rc = ref(jnp.asarray(x), rc, None)
    got, pc = A.apply(pp, torch.from_numpy(x), acfg, pq, cache=pc)
    _close(_np(got), want, FLOAT_RTOL)
    pos = np.array([6, 4], np.int32)
    for step in range(10):
        xd = RNG.normal(size=(2, 1, 128)).astype(np.float32)
        want, rc = ref(jnp.asarray(xd), rc, jnp.asarray(pos + step))
        got, pc = A.apply(pp, torch.from_numpy(xd), acfg, pq, cache=pc,
                          pos=torch.from_numpy(pos + step))
        _close(_np(got), want, FLOAT_RTOL)
    for leaf in ("k", "v"):
        _close(_np(pc[leaf]), rc[leaf], FLOAT_RTOL)


@pytest.mark.parametrize("entry", ["attention", "prefill", "engine"])
def test_a_prefill_longer_than_the_ring_is_refused(entry):
    """Nine tokens do not fit an 8-slot ring: each entry raises
    ValueError; eight do, and a cache shorter than the window (no ring)
    takes any prompt it holds."""
    _, pcfg, _, pparams = _arch("gemma3-27b")
    toks = torch.from_numpy(RNG.integers(0, pcfg.vocab, (1, 9)))
    if entry == "attention":
        acfg = pcfg.attn_cfg("local")
        _, pp = _layer_params("gemma3-27b", "local")
        cache = A.init_cache(acfg, 1, RING_MAX_LEN, torch.float32)
        x = torch.from_numpy(RNG.normal(size=(1, 9, 128)).astype(np.float32))
        with pytest.raises(ValueError, match="ring buffer of 8 slots"):
            A.apply(pp, x, acfg, for_lm("bf16"), cache=cache)
        A.apply(pp, x[:, :8], acfg, for_lm("bf16"), cache=cache)
        A.apply(pp, x[:, :6], acfg, for_lm("bf16"),
                cache=A.init_cache(acfg, 1, 6, torch.float32))
    elif entry == "prefill":
        cache = PT.init_cache(pcfg, 1, RING_MAX_LEN, torch.float32, "cpu")
        with pytest.raises(ValueError, match="ring buffer of 8 slots"):
            PT.prefill(pparams, toks, pcfg, cache)
        PT.prefill(pparams, toks[:, :8], pcfg, cache)
    else:
        eng = Engine(pcfg, pparams, slots=1, max_len=RING_MAX_LEN,
                     device="cpu")
        with pytest.raises(ValueError, match="8-slot ring buffer"):
            eng.submit(ServeRequest(rid=0, prompt=toks[0].numpy()))
        eng.submit(ServeRequest(rid=1, prompt=toks[0, :8].numpy(),
                                max_new=2))
        eng.run()
        assert [r.rid for r in eng.completed] == [1]
        short = Engine(pcfg, pparams, slots=1, max_len=7, device="cpu")
        short.submit(ServeRequest(rid=2, prompt=toks[0, :6].numpy(),
                                  max_new=1))
        short.run()


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["bf16", "int8_exact"])
def test_mla_apply_with_cache_matches_reference(backend):
    """Prefill of 6 tokens into the compressed cache, then four
    vector-position decode steps: outputs and the ckv / kpe cache leaves
    agree with the JAX package's within MLA_RTOL / MLA_ATOL."""
    rcfg, pcfg = _arch("deepseek-v2-236b")[:2]
    racfg, acfg = rcfg.attn_cfg("self"), pcfg.attn_cfg("self")
    rp, pp = _layer_params("deepseek-v2-236b", "attn")
    rq, pq = RQ.for_lm(backend), for_lm(backend)
    rc = RA.init_cache(racfg, 2, 12, jnp.float32)
    pc = A.init_cache(acfg, 2, 12, torch.float32)
    ref = jax.jit(lambda x, c, pos: RA.apply(
        rp, x, racfg, DEFAULT_RULES, rq, cache=c, pos=pos))
    x = RNG.normal(size=(2, 6, 128)).astype(np.float32)
    want, rc = ref(jnp.asarray(x), rc, None)
    got, pc = A.apply(pp, torch.from_numpy(x), acfg, pq, cache=pc)

    def close(a, b):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=MLA_RTOL,
                                   atol=MLA_ATOL)

    close(got, want)
    pos = np.array([6, 3], np.int32)
    for step in range(4):
        xd = RNG.normal(size=(2, 1, 128)).astype(np.float32)
        want, rc = ref(jnp.asarray(xd), rc, jnp.asarray(pos + step))
        got, pc = A.apply(pp, torch.from_numpy(xd), acfg, pq, cache=pc,
                          pos=torch.from_numpy(pos + step))
        close(got, want)
    for leaf in ("ckv", "kpe"):
        close(pc[leaf], rc[leaf])


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

def _ref_dispatch(ids: np.ndarray, s: int, cfg) -> dict:
    """The reference's group-local dispatch (``repro.nn.moe.apply``) on its
    own expert ids: a stable sort by expert, capacity by Python's round,
    the drop slot E * cap."""
    b = ids.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    gk = s * K
    cap = int(max(1, round(gk / E * cfg.capacity_factor)))
    se = ids.reshape(b, gk)
    st = np.broadcast_to(np.repeat(np.arange(s), K)[None], (b, gk))
    order = np.argsort(se, axis=1, kind="stable")
    se = np.take_along_axis(se, order, 1)
    st = np.take_along_axis(st, order, 1)
    idx = np.broadcast_to(np.arange(gk)[None], (b, gk))
    starts = np.full((b, E), gk)
    for bi in range(b):
        np.minimum.at(starts[bi], se[bi], idx[bi])
    pos_in_e = idx - np.take_along_axis(starts, se, 1)
    keep = pos_in_e < cap
    return {"cap": cap, "token": st, "expert": se, "keep": keep,
            "slot": np.where(keep, se * cap + pos_in_e, E * cap)}


@pytest.mark.parametrize("variant", ["plain", "qat", "int8_gather",
                                     "decode"])
def test_moe_apply_matches_reference(monkeypatch, variant):
    """Expert ids (caught at the reference's ``top_k``), the capacity keep
    mask and the slots equal the JAX package's; the output and the aux
    loss agree within FLOAT_RTOL. 'qat' fake-quantizes the experts,
    'int8_gather' runs the reference's int8 weight gather (one device: a
    per-(expert, channel) fake-quant), 'decode' routes four one-token
    groups, as a decode step does (nothing is dropped there). (bf16
    weights are not compared: the JAX package's bf16 expert einsums with
    float32 accumulation do not run on its CPU backend.)"""
    rcfg = _arch("deepseek-v2-236b")[0]
    rmc = rcfg.moe_cfg()
    rp, pp = _layer_params("deepseek-v2-236b", "moe")
    if variant == "int8_gather":
        rmc = dataclasses.replace(rmc, int8_gather=True)
    pmc = MOE.MoEConfig(**dataclasses.asdict(rmc))
    shape = (4, 1, 128) if variant == "decode" else (2, 12, 128)
    x = RNG.normal(size=shape).astype(np.float32)
    xr, xp = jnp.asarray(x), torch.from_numpy(x)
    caught = {}
    top_k = jax.lax.top_k

    def spy(a, k):
        out = top_k(a, k)
        jax.debug.callback(
            lambda ids: caught.__setitem__("ids", np.asarray(ids)), out[1])
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want, want_aux = jax.jit(lambda p, x: RMOE.apply(
        p, x, rmc, DEFAULT_RULES, RQ.BF16, qat=variant == "qat"))(rp, xr)
    jax.block_until_ready(want)
    monkeypatch.undo()
    got, aux = MOE.apply(pp, xp, pmc, for_lm("bf16"), qat=variant == "qat")
    route = MOE.route(pp, xp, pmc)
    np.testing.assert_array_equal(route["ids"].numpy(), caught["ids"])
    ref = _ref_dispatch(caught["ids"], shape[1], rmc)
    assert route["cap"] == ref["cap"]
    for key in ("token", "expert", "keep", "slot"):
        np.testing.assert_array_equal(route[key].numpy(), ref[key],
                                      err_msg=key)
    assert ref["keep"].all() == (variant == "decode"), \
        "the 12-token groups must drop entries, decode's none"
    _close(_np(got), np.asarray(want, np.float32), FLOAT_RTOL)
    assert abs(float(aux) - float(want_aux)) <= FLOAT_RTOL


# ---------------------------------------------------------------------------
# The archs: trees, loss, prefill -> decode, projections
# ---------------------------------------------------------------------------

def _shapes(tree):
    out = []
    jax.tree.map(lambda t: out.append(tuple(t.shape)), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_trees_match_reference(arch):
    """The parameter and cache trees have the reference's keys, layout and
    shapes (the cache per layer kind: an 8-slot ring for gemma3's local
    layers, ckv / kpe for MLA)."""
    rcfg, pcfg, rparams, pparams = _arch(arch)
    assert jax.tree.structure(jax.tree.map(np.asarray, rparams)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), pparams))
    assert _shapes(rparams) == _shapes(jax.tree.map(lambda t: t.numpy(),
                                                    pparams))
    assert M.n_params(PT.descs(pcfg)) == sum(
        int(np.prod(s)) for s in _shapes(rparams))
    rc = jax.eval_shape(lambda: RT.init_cache(rcfg, 3, 20, jnp.float32))
    pc = PT.init_cache(pcfg, 3, 20, torch.float32, "cpu")
    assert _shapes(rc) == _shapes(jax.tree.map(lambda t: t.numpy(), pc))
    if arch == "gemma3-27b":
        assert pc["blocks"][0]["k0_local"]["k"].shape[2] == 8
        assert pc["blocks"][0]["k5_global"]["k"].shape[2] == 20
    if arch == "hymba-1.5b":
        assert pc["blocks"][0]["k0_hymba"]["attn"]["k"].shape[2] == 8
    if pcfg.ssm:     # recurrent states are float32 whatever the cache dtype
        bf = PT.init_cache(pcfg, 1, 20, torch.bfloat16, "cpu")["blocks"][0]
        key = next(iter(bf))
        assert {n: t.dtype for n, t in bf[key].items() if n != "attn"} == \
            dict.fromkeys(("S", "xprev", "cm_xprev") if arch == "rwkv6-3b"
                          else ("h", "conv"), torch.float32)


DECODE_STEPS = [np.array([6 + i, 4 + i]) for i in range(6)]


def _tokens():
    return np.random.default_rng(5).integers(0, 512, (2, 12)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, backend: str):
    """The JAX package's loss over 12 tokens, then prefill of 6 and six
    vector-position decode steps (rows at depths 6 and 4, past gemma3's
    window of 8): (loss, [logits rows])."""
    rcfg, _, rparams, _ = _arch(arch)
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    toks = jnp.asarray(_tokens())
    loss = jax.jit(lambda p, t: RT.forward_loss(
        p, {"tokens": t, "labels": t}, cfg))(rparams, toks)
    cache = RT.init_cache(cfg, 2, RING_MAX_LEN, jnp.float32)
    lg, cache = jax.jit(lambda p, t, c: RT.prefill(p, t, cfg, c))(
        rparams, toks[:, :6], cache)
    logits = [np.asarray(lg)]
    dec = jax.jit(lambda p, t, pos, c: RT.decode_step(p, t, pos, cfg, c))
    for i, step in enumerate(DECODE_STEPS):
        lg, cache = dec(rparams, toks[:, 6 + i:7 + i],
                        jnp.asarray(step, jnp.int32), cache)
        logits.append(np.asarray(lg))
    return float(loss), logits


@functools.lru_cache(maxsize=None)
def _port_run(arch: str, backend: str):
    _, pcfg, _, pparams = _arch(arch)
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        loss = PT.forward_loss(pparams, {"tokens": toks, "labels": toks},
                               cfg)
        cache = PT.init_cache(cfg, 2, RING_MAX_LEN, torch.float32, "cpu")
        lg, cache = PT.prefill(pparams, toks[:, :6], cfg, cache)
        logits = [_np(lg)]
        for i, step in enumerate(DECODE_STEPS):
            lg, cache = PT.decode_step(pparams, toks[:, 6 + i:7 + i],
                                       torch.from_numpy(step), cfg, cache)
            logits.append(_np(lg))
    return float(loss), logits


def _rtol(backend):
    return FLOAT_RTOL if backend == "bf16" else QUANT_RTOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_loss_matches_reference(arch, backend):
    """forward_loss, the MoE archs' aux loss included, agrees with the
    JAX package's within the backend's tolerance (an absolute bound: the
    loss is near log(vocab))."""
    want = _jax_run(arch, _ref_backend(backend))[0]
    got = _port_run(arch, backend)[0]
    assert abs(got - want) <= _rtol(backend) * 0.1, (got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_decode_logits_match_reference(arch, backend):
    """prefill's next-token logits and six vector-position decode steps'
    (gemma3's rings wrap) agree with the JAX package's within the
    backend's tolerance of their range."""
    want = _jax_run(arch, _ref_backend(backend))[1]
    got = _port_run(arch, backend)[1]
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        _close(g, w, _rtol(backend))


class _Spy:
    """Records the (x, w) of every ``quantized_matmul`` the port's layers
    make."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = L.quantized_matmul

        def spy(x, w, cfg, bias=None, activation=None):
            self.calls.append((x.detach().clone(), w.detach().clone()))
            return inner(x, w, cfg, bias=bias, activation=activation)

        monkeypatch.setattr(L, "quantized_matmul", spy)


@pytest.mark.parametrize("arch", ARCHS)
def test_projection_codes_and_accumulators_bitwise(monkeypatch, arch):
    """Every quantized projection of a prefill (attention, MLA's wq / wdkv /
    wo, the dense MLP, the head): on the same input rows and weights, the
    port's int8 codes and its approx_deficit_pallas int32 accumulators
    equal the JAX package's approx_lut codes and accumulators bit for
    bit."""
    _, pcfg, _, pparams = _arch(arch)
    cfg = dataclasses.replace(pcfg, quant=for_lm("approx_deficit_pallas"))
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        PT.prefill(pparams, torch.from_numpy(_tokens()[:1, :8]).long(), cfg,
                   PT.init_cache(cfg, 1, RING_MAX_LEN, torch.float32, "cpu"))
    n_proj = {"gemma3-27b": 7 * 6, "deepseek-v2-236b": 3 * 2,
              "kimi-k2-1t-a32b": 4 * 2, "rwkv6-3b": 8 * 2,
              "hymba-1.5b": 10 * 2}[arch]
    assert len(spy.calls) == n_proj + 1
    for i, (x, w) in enumerate(spy.calls):
        x2 = x.reshape(-1, x.shape[-1])
        xq, _ = quantize_dynamic(x2, axis=-1)
        wq, _ = quantize_dynamic(w, axis=0)
        acc = QM.integer_matmul(xq, wq.contiguous(),
                                QuantConfig("approx_deficit_pallas"))
        wxq, wacc = _jax_codes(jnp.asarray(_np(x2)), jnp.asarray(_np(w)))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(wxq),
                                      err_msg=f"projection {i} codes")
        np.testing.assert_array_equal(acc.numpy(), np.asarray(wacc),
                                      err_msg=f"projection {i} sums")


@jax.jit
def _jax_codes(x, w):
    """The JAX package's codes and approx_lut sums of one projection (one
    compile per shape, shared by the archs: all are 128 wide)."""
    xq, _ = RQ.quantize_dynamic(x, axis=-1)
    wq, _ = RQ.quantize_dynamic(w, axis=0)
    return xq, RQM.integer_matmul(xq, wq, RQ.QuantConfig("approx_lut"))

"""The port's cross-attention (``nn/attention.py``'s ``cross`` kind) and
llama-3.2-vision-11b at ``registry.reduced`` (d_model 128, 4 heads over 1
KV head of 32, encoder states of 16 x 64), its group of four self layers
and a cross layer cut to one of each (CUT: the same layer kinds, two
fifths of the reference's trace; the 4:1 program is held in
``tests/test_torch_lm.py``'s config cases), against the JAX package's, on
the same numpy inputs; the weights are the port's init at seed 0 (the reference's
scales), passed to the JAX package as numpy arrays and back through
``repro_torch.convert.params_from_jax``. Each JAX function is traced once
per backend (the file's cost is the traces).

Where the port runs ``approx_deficit_pallas`` the JAX side runs its oracle
``approx_lut``: the JAX package's own tests hold its Pallas entries to
their oracles bit for bit, and its interpret mode takes minutes at these
sizes. On the CPU the port's ``*_pallas`` backends run their kernels'
plain versions.

What is claimed, and within what:
  * the attention module within FLOAT_RTOL of its range, at 16 encoder
    states and at 1,100 (two KV chunks of 1,024, the second padded with
    key position -1), under bf16 and the integer backends; q's rows are
    the queries', k's and v's the encoder states';
  * int8 codes and int32 accumulators of every quantized projection equal
    bit for bit given the same input rows (the port's own inputs,
    recorded during its forward), the cross layer's K and V over the
    projected encoder states included;
  * the loss and logits under bf16 within FLOAT_RTOL; the logits under
    approx_deficit_pallas within QUANT_RTOL of their range (torch's silu
    rounds otherwise than XLA's in last places, and a last place at a
    rounding boundary moves a later int8 code: ROADMAP queue C);
  * float32 decode steps within CACHE_FREE_RTOL of their range of a
    cache-free forward over the whole sequence;
  * one QAT training step's loss and straight-through gradients
    (fake-quant weights; ``enc_proj.w`` included) within GRAD_RTOL,
    absolute: each leaf within GRAD_RTOL * max(1, its largest) [a CPU run:
    7e-8, which is 2.3e-6 of that leaf's largest; every gradient is below
    1; the float32 matmuls of the two libraries sum the rows of
    dw = x.T @ g in other orders]. Each channel's largest weight is left
    out, where the compiled reference's straight-through mask disagrees
    with the eager one (ROADMAP queue C, ``tests/test_torch_lm_train.py``).
    Under an integer backend the whole model's straight-through gradients
    are not held: one int8 activation code moved by a last-place silu
    difference moves a token's downstream activations by a quantization
    step, and the gradients by up to 2.5e-2 of a leaf's largest (measured
    here under int8_exact; ROADMAP queue C).
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
from repro.parallel.sharding import DEFAULT_RULES
from repro.quant import matmul as RQM

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import transformer_lm as PT
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.optim import adamw as AW
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig, for_lm, quantize_dynamic
from repro_torch.train.cnn_train import value_and_grad

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

ARCH = "llama-3.2-vision-11b"
BACKENDS = ("bf16", "approx_deficit_pallas")
FLOAT_RTOL = 1e-5
QUANT_RTOL = 2e-2
CACHE_FREE_RTOL = 1e-4
GRAD_RTOL = 1e-6
PROMPT, STEPS = 6, 4
CUT = dict(n_layers=2, cross_every=2)     # [(1, ('self', 'cross'))]
RNG = np.random.default_rng(20)


def _ref_backend(name: str) -> str:
    return name if name == "bf16" else RQM.get_backend(name).oracle or name


def _close(got, want, rtol):
    """|got - want| <= rtol * the range of ``want`` (at least 1)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    bound = rtol * max(1.0, float(np.ptp(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _arch():
    """(JAX cfg, port cfg, JAX params, port params) of the reduced llama,
    cut to CUT."""
    rcfg, pcfg = RR.reduced(ARCH, **CUT), PR.reduced(ARCH, **CUT)
    assert pcfg.blocks() == rcfg.blocks() == [(1, ("self", "cross"))]
    arrays = params_to_numpy(PT.init(pcfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, arrays),
            params_from_jax(arrays, device="cpu"))


@functools.lru_cache(maxsize=None)
def _inputs():
    """Tokens (2, PROMPT + STEPS) and encoder states (2, 16, 64)."""
    rng = np.random.default_rng(5)
    cfg = _arch()[1]
    toks = rng.integers(0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    enc = rng.normal(size=(2, cfg.enc_len, cfg.enc_dim)).astype(np.float32)
    return toks, enc


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


def _assert_codes_bitwise(calls, port_backend: str, ref_backend: str):
    """Each recorded projection's int8 codes and int32 sums equal the JAX
    package's on the same rows and weights."""
    for i, (x, w) in enumerate(calls):
        x2 = x.reshape(-1, x.shape[-1])
        xq, _ = quantize_dynamic(x2, axis=-1)
        wq, _ = quantize_dynamic(w, axis=0)
        acc = QM.integer_matmul(xq, wq.contiguous(),
                                QuantConfig(port_backend))
        wxq, wacc = _jax_codes(jnp.asarray(_np(x2)), jnp.asarray(_np(w)),
                               ref_backend)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(wxq),
                                      err_msg=f"projection {i} codes")
        np.testing.assert_array_equal(acc.numpy(), np.asarray(wacc),
                                      err_msg=f"projection {i} sums")


@functools.partial(jax.jit, static_argnums=2)
def _jax_codes(x, w, backend):
    xq, _ = RQ.quantize_dynamic(x, axis=-1)
    wq, _ = RQ.quantize_dynamic(w, axis=0)
    return xq, RQM.integer_matmul(xq, wq, RQ.QuantConfig(backend))


# ---------------------------------------------------------------------------
# The cross-attention module
# ---------------------------------------------------------------------------

def _cross_case(enc_len: int):
    """(JAX cfg, port cfg, JAX params, port params, x, enc): the reduced
    llama's cross layer at 16 encoder states; at 1,100 a narrow layer
    (d_model 32, 2 heads over 1 KV head of 16), random weights."""
    if enc_len == 16:
        rcfg, pcfg, rparams, pparams = _arch()
        racfg, acfg = rcfg.attn_cfg("cross"), pcfg.attn_cfg("cross")
        rp = jax.tree.map(lambda t: t[0], rparams["blocks"][0])["k1_cross"]
        pp = PT.map_leaves(lambda t: t[0], pparams["blocks"][0])["k1_cross"]
        rp, pp = rp["attn"], pp["attn"]
    else:
        racfg = RA.AttnConfig(32, 2, 1, 16, cross=True)
        acfg = A.AttnConfig(32, 2, 1, 16, cross=True)
        rng = np.random.default_rng(enc_len)
        arrs = {k: (rng.normal(size=shape) / np.sqrt(shape[0])
                    ).astype(np.float32)
                for k, shape in (("wq", (32, 32)), ("wk", (32, 16)),
                                 ("wv", (32, 16)), ("wo", (32, 32)))}
        rp = jax.tree.map(jnp.asarray, arrs)
        pp = {k: torch.from_numpy(v) for k, v in arrs.items()}
    d = acfg.d_model
    x = RNG.normal(size=(2, 3, d)).astype(np.float32)
    enc = RNG.normal(size=(2, enc_len, d)).astype(np.float32)
    return racfg, acfg, rp, pp, x, enc


@pytest.mark.parametrize("enc_len,backend", [
    (16, "bf16"), (1100, "bf16"), (1100, "int8_exact"),
    (1100, "approx_lut")])
def test_cross_attention_matches_reference(monkeypatch, enc_len, backend):
    """Queries from x, keys and values from the encoder states, no RoPE,
    every key visible (past the 1,024-key chunk too, whose padding is
    masked): the output within FLOAT_RTOL of the reference's, the cache
    returned as given; under an integer backend q's, k's and v's codes and
    sums bitwise the reference's, on x's rows for q and enc's for k, v."""
    racfg, acfg, rp, pp, x, enc = _cross_case(enc_len)
    spy = _Spy(monkeypatch)
    got, cache = A.apply(pp, torch.from_numpy(x), acfg, for_lm(backend),
                         enc=torch.from_numpy(enc))
    want, rcache = jax.jit(lambda x, e: RA.apply(
        rp, x, racfg, DEFAULT_RULES, RQ.for_lm(backend), enc=e))(
        jnp.asarray(x), jnp.asarray(enc))
    assert cache is None and rcache is None
    assert tuple(got.shape) == x.shape
    _close(_np(got), want, FLOAT_RTOL)
    if backend == "bf16":
        return
    q, k, v = spy.calls[:3]
    np.testing.assert_array_equal(_np(q[0]), x)
    for t in (k, v):
        np.testing.assert_array_equal(_np(t[0]), enc)
    _assert_codes_bitwise(spy.calls[:3], backend, backend)


def test_cross_attention_sees_every_key_and_no_position():
    """A query attends to all encoder states whatever its position (no
    causal mask, no RoPE): shifting the decode position changes nothing,
    and the last encoder state moves the output."""
    _, acfg, _, pp, x, enc = _cross_case(16)
    q = for_lm("bf16")
    xt, et = torch.from_numpy(x[:, :1]), torch.from_numpy(enc)
    a, _ = A.apply(pp, xt, acfg, q, enc=et, pos=0)
    b, _ = A.apply(pp, xt, acfg, q, enc=et, pos=torch.tensor([7, 11]))
    assert torch.equal(a, b)
    et2 = et.clone()
    et2[:, -1] += 1.0
    c, _ = A.apply(pp, xt, acfg, q, enc=et2)
    assert not torch.allclose(a, c)


# ---------------------------------------------------------------------------
# llama-3.2-vision reduced: loss, prefill -> decode, projections
# ---------------------------------------------------------------------------

DECODE_POS = [np.array([PROMPT + i, PROMPT + i]) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_logits(backend: str):
    """The JAX package's prefill of PROMPT tokens with the encoder states,
    then STEPS vector-position decode steps: [logits rows]."""
    rcfg, _, rparams, _ = _arch()
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    toks, enc = (jnp.asarray(a) for a in _inputs())
    cache = RT.init_cache(cfg, 2, 16, jnp.float32)
    lg, cache = jax.jit(lambda p, t, c, e: RT.prefill(p, t, cfg, c, enc=e))(
        rparams, toks[:, :PROMPT], cache, enc)
    out = [np.asarray(lg)]
    dec = jax.jit(lambda p, t, pos, c, e: RT.decode_step(p, t, pos, cfg, c,
                                                         enc=e))
    for i, pos in enumerate(DECODE_POS):
        lg, cache = dec(rparams, toks[:, PROMPT + i:PROMPT + i + 1],
                        jnp.asarray(pos, jnp.int32), cache, enc)
        out.append(np.asarray(lg))
    return out


@functools.lru_cache(maxsize=None)
def _port_logits(backend: str):
    _, pcfg, _, pparams = _arch()
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    toks, enc = (torch.from_numpy(a) for a in _inputs())
    toks = toks.long()
    with torch.no_grad():
        cache = PT.init_cache(cfg, 2, 16, torch.float32, "cpu")
        lg, cache = PT.prefill(pparams, toks[:, :PROMPT], cfg, cache,
                               enc=enc)
        logits = [_np(lg)]
        for i, pos in enumerate(DECODE_POS):
            lg, cache = PT.decode_step(
                pparams, toks[:, PROMPT + i:PROMPT + i + 1],
                torch.from_numpy(pos), cfg, cache, enc=enc)
            logits.append(_np(lg))
    return logits


def _rtol(backend):
    return FLOAT_RTOL if backend == "bf16" else QUANT_RTOL


def test_forward_loss_matches_reference():
    """forward_loss with the encoder states (bf16: float32 projections)
    agrees with the JAX package's within FLOAT_RTOL (the QAT loss: in
    ``test_qat_gradients_match_reference``; quantized logits: in
    ``test_prefill_decode_logits_match_reference``)."""
    rcfg, pcfg, rparams, pparams = _arch()
    toks, enc = _inputs()
    want = jax.jit(lambda p, t, e: RT.forward_loss(
        p, {"tokens": t, "labels": t, "enc": e}, rcfg))(
        rparams, jnp.asarray(toks), jnp.asarray(enc))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        got = PT.forward_loss(pparams, {"tokens": t, "labels": t,
                                        "enc": torch.from_numpy(enc)}, pcfg)
    assert abs(float(got) - float(want)) <= FLOAT_RTOL * abs(float(want))


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_decode_logits_match_reference(backend):
    """prefill's next-token logits and the vector-position decode steps',
    each recomputing the cross layer's K and V from the encoder states,
    agree with the JAX package's within the backend's tolerance of their
    range."""
    want = _jax_logits(_ref_backend(backend))
    got = _port_logits(backend)
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, 512)
        _close(g, w, _rtol(backend))


def test_projection_codes_and_accumulators_bitwise(monkeypatch):
    """Every quantized projection of a prefill (the self layers', the
    cross layer's q, K and V over the 16 projected encoder states, o, the
    MLPs, the tied head): the port's approx_deficit_pallas codes and sums
    equal the JAX package's approx_lut ones bit for bit, on the same
    rows."""
    _, pcfg, _, pparams = _arch()
    cfg = dataclasses.replace(pcfg, quant=for_lm("approx_deficit_pallas"))
    toks, enc = _inputs()
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        PT.prefill(pparams, torch.from_numpy(toks[:1, :8]).long(), cfg,
                   PT.init_cache(cfg, 1, 16, torch.float32, "cpu"),
                   enc=torch.from_numpy(enc[:1]))
    assert len(spy.calls) == 7 * 2 + 1
    rows = [c[0].reshape(-1, c[0].shape[-1]).shape[0] for c in spy.calls]
    assert rows[7 + 1:7 + 3] == [cfg.enc_len] * 2           # cross K, V
    _assert_codes_bitwise(spy.calls, "approx_deficit_pallas", "approx_lut")


def test_decode_matches_cache_free_forward():
    """float32 weights under bf16: each decode step's logits within
    CACHE_FREE_RTOL of their range of a cache-free forward over the whole
    sequence (the reference's ``test_decode_matches_full_forward``)."""
    _, cfg, _, pparams = _arch()
    toks, enc = (torch.from_numpy(a) for a in _inputs())
    toks = toks.long()
    with torch.no_grad():
        h, _, _ = PT.backbone(pparams, PT.embed_tokens(pparams, toks, cfg),
                              cfg, enc=enc)
        ref = PT.lm_logits(pparams, h, cfg)
    got = _port_logits("bf16")
    for j, lg in enumerate(got):
        _close(lg[:, 0], _np(ref[:, PROMPT - 1 + j]), CACHE_FREE_RTOL)


def _not_quantized_max(path, w):
    """False at each (layer, output channel)'s largest |w| of a stacked
    layer weight and at each vocab row's largest of the head's table."""
    w = np.abs(np.asarray(w))
    if path[-1] == "table":
        return w != w.max(axis=1, keepdims=True)
    if path[0] != "blocks" or w.ndim < 3:
        return np.ones(w.shape, bool)
    return w != w.max(axis=tuple(range(1, w.ndim - 1)), keepdims=True)


def test_qat_gradients_match_reference():
    """One QAT training step's loss and gradients (``forward_loss`` with
    the encoder states, every projection a float matmul over its
    fake-quantized weight, the straight-through estimator in the backward)
    against ``jax.value_and_grad``, within GRAD_RTOL; ``enc_proj.w`` gets
    its gradient through the cross layer's K and V, also where each layer
    is recomputed in the backward (``cfg.remat``; the encoder states enter
    it from outside), bit for bit."""
    rcfg, pcfg, rparams, pparams = _arch()
    rc = dataclasses.replace(rcfg, quant=RQ.for_lm("approx_lut"))
    cfg = dataclasses.replace(pcfg, quant=for_lm("approx_deficit_pallas"))
    toks, enc = _inputs()
    rl, rg = jax.jit(jax.value_and_grad(lambda p, b: RT.forward_loss(
        p, b, rc, qat=True, training=True)))(rparams, {
            "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
            "enc": jnp.asarray(enc)})
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(toks).long(),
             "enc": torch.from_numpy(enc)}
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads[remat] = value_and_grad(
            lambda p, b: PT.forward_loss(p, b, c, qat=True, training=True),
            pparams, batch)
    for (path, g0), (_, g1) in zip(AW.flatten(grads[False]),
                                   AW.flatten(grads[True])):
        assert torch.equal(g0, g1), f"remat changed the gradient of {path}"
    assert abs(float(loss) - float(rl)) <= GRAD_RTOL * abs(float(rl))
    pairs, want = AW.flatten(grads[True]), jax.tree.leaves(rg)
    assert len(pairs) == len(want)
    assert any(p == ("enc_proj", "w") for p, _ in pairs)
    for (path, g), w, w0 in zip(pairs, want, jax.tree.leaves(rparams)):
        w = np.asarray(w, np.float64)
        scale = float(np.abs(w).max())
        assert scale > 0, path
        keep = _not_quantized_max(path, w0)
        np.testing.assert_allclose(g.double().numpy()[keep], w[keep],
                                   rtol=0, atol=GRAD_RTOL * max(1.0, scale),
                                   err_msg=str(path))


def test_backbone_refuses_a_cross_config_without_encoder_states():
    _, cfg, _, pparams = _arch()
    toks = torch.from_numpy(_inputs()[0]).long()
    with pytest.raises(ValueError, match="encoder states"):
        PT.backbone(pparams, PT.embed_tokens(pparams, toks, cfg), cfg)
    with pytest.raises(ValueError, match="encoder states"):
        PT.prefill(pparams, toks, cfg,
                   PT.init_cache(cfg, 2, 16, torch.float32, "cpu"))


def test_cache_tree_has_no_cross_leaves():
    """A cross layer's cache is ``{}`` in both packages (its K and V are
    recomputed from the encoder states); the page functions, write_slot
    and rollback pass it through."""
    rcfg, cfg, _, _ = _arch()
    pc = PT.init_cache(cfg, 2, 16, torch.float32, "cpu")
    rc = jax.eval_shape(lambda: RT.init_cache(rcfg, 2, 16, jnp.float32))
    assert pc["blocks"][0]["k1_cross"] == {} == rc["blocks"][0]["k1_cross"]
    shapes = []
    jax.tree.map(lambda t: shapes.append(tuple(t.shape)), rc)
    got = []
    PT.map_leaves(lambda t: got.append(tuple(t.shape)), pc)
    assert got == shapes
    one = PT.init_cache(cfg, 1, 16, torch.float32, "cpu")
    PT.map_leaves(lambda t: t.fill_(1.0), one)
    PT.write_slot(pc, one, 1)
    PT.rollback_positions(pc, np.array([0, 4]), np.array([0, 16]))
    k = pc["blocks"][0]["k0_self"]["k"]
    assert float(k[:, 0].abs().sum()) == 0
    assert bool((k[:, 1, :4] == 1).all()) and float(k[:, 1, 4:].sum()) == 0
    pages = PT.init_page_store(cfg, 3, 4, torch.float32, "cpu")
    PT.store_pages(pages, pc, 1, [2], [0])
    row = PT.gather_pages(PT.init_cache(cfg, 1, 16, torch.float32, "cpu"),
                          pages, [2])
    assert row["blocks"][0]["k1_cross"] == {}
    assert bool((row["blocks"][0]["k0_self"]["v"][:, 0, :4] == 1).all())

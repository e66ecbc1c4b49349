"""The port's LM training path against the JAX package's: the token
stream, the QAT forward loss (fake-quant in every projection and the tied
head), one ``make_train_step(qat=True)`` step (with and without gradient
accumulation), the serve step, and AdamW's leaf order over the LM's
``blocks`` list, on the same numpy inputs and starting weights.

The model is the reduced smollm of the JAX package's LM tests (2 layers,
d_model 64, 4 heads / 2 KV heads of 16, d_ff 128, vocab 256), its weights
the JAX package's ``TLM.init`` at key 0 carried across by
``repro_torch.convert``. Tolerances, relative to the largest magnitude of
the reference leaf they bound (a CPU run's largest gap in brackets):
  * token stream: bit for bit (the same numpy calls);
  * QAT loss: LOSS_RTOL [2.4e-7]: the float matmuls of the two libraries
    sum in other orders;
  * one train step: STEP_RTOL for the loss and the gradients [9.4e-6], the
    updated weights STEP_RTOL absolute [3.9e-6], as tests/test_torch_train.py
    holds the CNN steps (Adam's first update divides each gradient element
    by its own magnitude, so the weights' error scales with lr).
The archs of the port's training path (gemma3, deepseek-v2, rwkv6,
hymba) take one such step each at ``registry.reduced`` (float32 weights,
the port's init at seed 0, whose scales are the reference's; gemma3 as
one local and one global layer), with float32 AdamW moments: the loss
[1.5e-7] and the first moment (0.1 x the clipped gradient) [4.7e-5]
within STEP_RTOL, the updated weights within STEP_RTOL absolute
[1.1e-5], except where the reference's
gradient is below NOISE_FLOOR of its leaf's largest: Adam's first update
is g / (|g| + eps), so there it divides float32 noise by a noise-sized
gradient (from the JAX package's init, hymba's worst weight gap, 3.1e-4,
sat at a gradient 1.1e-7 of its leaf's largest).
One place is left out of the gradient and weight comparisons, each
channel's largest weight of the layer matrices: there the straight-through
mask ``|w| <= scale * 127`` with ``scale = max|w| / 127`` holds in IEEE
float32, and the port (like the JAX package's fake-quant called eagerly,
which the test checks) passes the gradient; inside the reference's
``lax.scan`` over layers XLA compiles the scale so that the mask fails at
some of these weights, and their gradient is 0 there. For the archs the
head's largest weight of each vocab row is left out too (untied, or the
tied embedding): there the two packages' masks also disagree, either way
(on the reduced hymba the port's eager mask fails at a row maximum that
the compiled reference passes).
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
from repro.data import synthetic as RD
from repro.models import transformer_lm as RT
from repro.optim import adamw as RA
from repro.train import steps as RS

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.data import synthetic as PD
from repro_torch.models import transformer_lm as PT
from repro_torch.optim import adamw as A
from repro_torch.quant import quantize as PQ
from repro_torch.quant.quantize import for_lm
from repro_torch.train import steps as ST
from repro_torch.train.cnn_train import value_and_grad

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, vocab_pad=256, head_dim=16)
LOSS_RTOL = 1e-5
STEP_RTOL = 1e-4
NOISE_FLOOR = 1e-5
TRAIN_ARCHS = ("gemma3-27b", "deepseek-v2-236b", "rwkv6-3b", "hymba-1.5b")
# gemma3's reduced 5:1 group cut to one local and one global layer: the
# same layer kinds, a third of the reference's trace (its 5:1 program is
# held in tests/test_torch_archs.py)
ARCH_CUTS = {"gemma3-27b": dict(n_layers=2, local_ratio=1)}


@functools.lru_cache(maxsize=None)
def _tiny():
    rcfg = RR.reduced("smollm-135m", **TINY)
    pcfg = PR.reduced("smollm-135m", **TINY)
    rparams = jax.tree.map(np.asarray, jax.jit(RT.init, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0)))
    return rcfg, pcfg, rparams


def _batch(n=4, seq=16, seed=3):
    toks = RD.token_stream(n, seq + 1, TINY["vocab"], seed=seed)
    return toks[:, :-1], toks[:, 1:]


def _torch_batch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def _jax_batch(tokens, labels):
    return {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}


def _close(got, want, rtol, absolute=False, keep=None):
    """|got - want| <= rtol * max|want| (with ``absolute``, rtol *
    max(1, max|want|)), over the elements ``keep`` selects (all if
    None)."""
    want = np.asarray(want, np.float64)
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max())
    bound = rtol * (max(1.0, scale) if absolute else scale)
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=max(bound, np.finfo(np.float32).tiny))


def _not_channel_max(path, w):
    """False at each output channel's largest |w| of a layer matrix (the
    stacked (layers, d_in, d_out) leaves of ``blocks``), True elsewhere."""
    w = np.abs(np.asarray(w))
    if path[0] != "blocks" or w.ndim != 3:
        return np.ones(w.shape, bool)
    return w != w.max(axis=1, keepdims=True)


@pytest.mark.parametrize("n,seq,vocab,seed", [
    (64, 33, 256, 0), (32, 65, 512, 7), (5, 9, 49152, 3)])
def test_token_stream_bit_identical(n, seq, vocab, seed):
    got = PD.token_stream(n, seq, vocab, seed=seed)
    want = RD.token_stream(n, seq, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_adamw_flatten_follows_jax_leaf_order_through_lists():
    """The LM keeps its stacked layer groups in a ``blocks`` list: flatten
    walks it in order, as ``jax.tree.leaves`` does, and unflatten rebuilds
    the list."""
    rparams = _tiny()[2]
    pparams = params_from_jax(rparams, device="cpu")
    pairs = A.flatten(pparams)
    want = jax.tree.leaves(rparams)
    assert len(pairs) == len(want)
    for (_, got), w in zip(pairs, want):
        np.testing.assert_array_equal(got.numpy(), w)
    back = A.unflatten(pairs)
    assert isinstance(back["blocks"], list)
    assert [p for p, _ in A.flatten(back)] == [p for p, _ in pairs]


@pytest.mark.parametrize("backend", ["bf16", "approx_lut"])
def test_qat_forward_loss_matches_reference(backend):
    """Under QAT every projection and the tied head (per vocab row) run as
    float matmuls over fake-quantized weights, whatever the backend."""
    rcfg, pcfg, rparams = _tiny()
    tokens, labels = _batch()
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    got = PT.forward_loss(params_from_jax(rparams, device="cpu"),
                          _torch_batch(tokens, labels), cfg, qat=True,
                          training=False)
    rc = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    want = jax.jit(lambda p, b: RT.forward_loss(p, b, rc, qat=True,
                                                training=False))(
        rparams, _jax_batch(tokens, labels))
    _close(got, want, LOSS_RTOL)
    plain = PT.forward_loss(params_from_jax(rparams, device="cpu"),
                            _torch_batch(tokens, labels),
                            dataclasses.replace(pcfg, quant=for_lm("bf16")))
    assert not torch.equal(got, plain), "qat changed nothing"


@pytest.mark.parametrize("microbatches", [1, 2])
def test_qat_train_step_matches_reference(microbatches):
    rcfg, pcfg, rparams = _tiny()
    tokens, labels = _batch()
    ocfg, rocfg = A.AdamWConfig(lr=2e-3), RA.AdamWConfig(lr=2e-3)
    rstep = jax.jit(RS.make_train_step(rcfg, rocfg, qat=True,
                                       num_microbatches=microbatches))
    rp, _, rm = rstep(jax.tree.map(jnp.asarray, rparams),
                      RA.init(RT.descs(rcfg), rocfg),
                      _jax_batch(tokens, labels))
    tp = params_from_jax(rparams, device="cpu")
    step = ST.make_train_step(pcfg, ocfg, qat=True,
                              num_microbatches=microbatches)
    new_p, new_s, metrics = step(tp, A.init(tp, ocfg),
                                 _torch_batch(tokens, labels))
    _close(metrics["loss"], rm["loss"], STEP_RTOL)
    assert int(new_s["count"][0]) == 1
    for (path, got), want, w0 in zip(A.flatten(new_p), jax.tree.leaves(rp),
                                     jax.tree.leaves(rparams)):
        assert got.shape == want.shape, path
        _close(got, want, STEP_RTOL, absolute=True,
               keep=_not_channel_max(path, w0))


def test_qat_gradients_match_reference_and_remat_changes_nothing():
    """The loss gradients against ``jax.grad``; recomputing each layer in
    the backward (``cfg.remat`` with ``training``) gives the same
    gradients bit for bit."""
    rcfg, pcfg, rparams = _tiny()
    tokens, labels = _batch(seed=5)
    rg = jax.jit(jax.grad(lambda p, b: RT.forward_loss(
        p, b, rcfg, qat=True, training=True)))(
        jax.tree.map(jnp.asarray, rparams), _jax_batch(tokens, labels))
    tp = params_from_jax(rparams, device="cpu")
    batch = _torch_batch(tokens, labels)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        _, grads[remat] = value_and_grad(
            lambda p, b: PT.forward_loss(p, b, cfg, qat=True,
                                         training=True), tp, batch)
    for (path, g0), (_, g1), want, w0 in zip(
            A.flatten(grads[False]), A.flatten(grads[True]),
            jax.tree.leaves(rg), jax.tree.leaves(rparams)):
        assert torch.equal(g0, g1), f"remat changed the gradient of {path}"
        _close(g0, want, STEP_RTOL, keep=_not_channel_max(path, w0))
    # the left-out weights: the port's mask is eager JAX's, element for
    # element, on layer 0's key projection
    w = jnp.asarray(rparams["blocks"][0]["k0_self"]["attn"]["wk"][0])
    r = np.random.default_rng(1).normal(size=w.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(RQ.fake_quant_per_channel(a) * r))(w)
    tw = torch.from_numpy(np.asarray(w)).requires_grad_(True)
    (PQ.fake_quant_per_channel(tw) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(want))


def test_qat_steps_lower_the_loss():
    """A few steps of the lm suite's recipe (QAT, lr 2e-3) on its token
    stream: finite losses that fall."""
    _, pcfg, rparams = _tiny()
    toks = PD.token_stream(32, 33, TINY["vocab"], seed=0)
    ocfg = A.AdamWConfig(lr=2e-3)
    params = params_from_jax(rparams, device="cpu")
    opt = A.init(params, ocfg)
    step = ST.make_train_step(pcfg, ocfg, qat=True)
    losses = []
    for i in range(6):
        idx = np.arange(8) + 8 * (i % 4)
        params, opt, m = step(params, opt, _torch_batch(toks[idx, :-1],
                                                        toks[idx, 1:]))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < losses[0]


def test_serve_step_is_greedy_decode_and_matches_reference():
    rcfg, pcfg, rparams = _tiny()
    cfg = dataclasses.replace(pcfg, quant=for_lm("int8_exact"))
    rc = dataclasses.replace(rcfg, quant=RQ.for_lm("int8_exact"))
    tokens, _ = _batch(n=2, seq=6)
    params = params_from_jax(rparams, device="cpu")
    with torch.no_grad():
        cache = PT.init_cache(cfg, 2, 16, torch.float32, "cpu")
        _, cache = PT.prefill(params, torch.from_numpy(tokens), cfg, cache)
        tok = torch.from_numpy(tokens[:, -1:])
        nxt, _ = ST.make_serve_step(cfg)(params, cache, tok, 6)
    rcache = RT.init_cache(rc, 2, 16, jnp.float32)
    _, rcache = RT.prefill(rparams, jnp.asarray(tokens), rc, rcache)
    rnxt, _ = RS.make_serve_step(rc)(rparams, rcache,
                                     jnp.asarray(tokens[:, -1:]),
                                     jnp.int32(6))
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2, 1)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(rnxt))


def _not_quantized_max(path, w):
    """``_not_channel_max`` for every fake-quantized leaf of the archs:
    each (layer, output channel)'s largest |w| of a stacked layer weight
    (the experts' (layers, E, d_in, d_out) leaves reduce over E and d_in,
    as ``moe`` fake-quantizes them), and each vocab row's largest of the
    head's table (untied, or the tied embedding)."""
    w = np.abs(np.asarray(w))
    if path[-1] == "table":
        return w != w.max(axis=1, keepdims=True)
    if path[0] != "blocks" or w.ndim < 3:
        return np.ones(w.shape, bool)
    return w != w.max(axis=tuple(range(1, w.ndim - 1)), keepdims=True)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_arch_qat_train_step_matches_reference(arch):
    """One ``make_train_step(qat=True)`` step of each trained arch (the
    mixture-of-experts aux loss in deepseek-v2's) against the reference's,
    from the same weights on the same batch."""
    kw = ARCH_CUTS.get(arch, {})
    rcfg, pcfg = RR.reduced(arch, **kw), PR.reduced(arch, **kw)
    rparams = params_to_numpy(PT.init(pcfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    toks = RD.token_stream(4, 17, rcfg.vocab, seed=3)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    ocfg, rocfg = A.AdamWConfig(lr=2e-3), RA.AdamWConfig(lr=2e-3)
    rp, rs, rm = jax.jit(RS.make_train_step(rcfg, rocfg, qat=True))(
        jax.tree.map(jnp.asarray, rparams), RA.init(RT.descs(rcfg), rocfg),
        _jax_batch(tokens, labels))
    tp = params_from_jax(rparams, device="cpu")
    new_p, new_s, metrics = ST.make_train_step(pcfg, ocfg, qat=True)(
        tp, A.init(tp, ocfg), _torch_batch(tokens, labels))
    _close(metrics["loss"], rm["loss"], STEP_RTOL)
    rmoment = jax.tree.leaves(rs["params"])[0::2]
    for (path, got), (_, m1), want, m_ref, w0 in zip(
            A.flatten(new_p), A.flatten(new_s["params"])[0::2],
            jax.tree.leaves(rp), rmoment, jax.tree.leaves(rparams)):
        keep = _not_quantized_max(path, w0)
        _close(m1, m_ref, STEP_RTOL, keep=keep)
        m_ref = np.abs(np.asarray(m_ref))
        _close(got, want, STEP_RTOL, absolute=True,
               keep=keep & (m_ref >= NOISE_FLOOR * m_ref.max()))

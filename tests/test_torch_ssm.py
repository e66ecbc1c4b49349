"""The port's SSM mixers (``nn/ssm.py``: RWKV6's WKV, time and channel mix,
Mamba-lite) and the two archs that use them (rwkv6-3b, hymba-1.5b) against
the JAX package's ``repro.nn.ssm``, on the same numpy inputs.

Weights are layer 0 of ``registry.reduced``'s archs (d_model 128, 4 heads,
RWKV6 head_dim 32, Mamba d_inner 128 and state 16), drawn by the JAX
package's ``TLM.init`` at key 0 and carried across by
``repro_torch.convert`` (``test_torch_archs._arch``, built once per
worker). Where the port runs ``approx_deficit_pallas`` (on the CPU, its
kernel's plain version), the JAX side runs its oracle ``approx_lut``.

What is claimed, and within what:
  * the chunked WKV equals the JAX package's within WKV_RTOL of the range,
    and the port's sequential WKV within SEQ_TOL, in y and in the final
    state (the contract of ``tests/test_rwkv_chunked.py``);
  * each mixer under ``bf16``: the output and every state leaf within
    FLOAT_RTOL of their range;
  * under a quantized backend: every projection's int8 codes and int32
    sums bitwise, given the same input rows; outputs and states within
    QUANT_RTOL, since the float side paths (the LoRAs, tanh, silu,
    sigmoid, softplus) may round otherwise than XLA's in the last place,
    and a last place at a rounding boundary moves a later int8 code;
  * the archs: decode after prefill equals a cache-free forward over the
    same tokens within DECODE_TOL, and ``forward_loss`` has finite,
    non-zero gradients.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as RS
from repro.parallel.sharding import DEFAULT_RULES
from repro.quant import matmul as RQM

from repro_torch.models import transformer_lm as PT
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as SSM
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig, for_lm, quantize_dynamic

from test_torch_archs import _arch, _jax_codes    # weights drawn once

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

WKV_RTOL = 1e-5
SEQ_TOL = 2e-4
FLOAT_RTOL = 1e-5
QUANT_RTOL = 2e-2
DECODE_TOL = 1e-4
MIXERS = ("tmix", "cmix", "mamba")
ARCHS = ("rwkv6-3b", "hymba-1.5b")


def _close(got, want, rtol):
    """|got - want| <= rtol * the range of ``want`` (at least 1)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    bound = rtol * max(1.0, float(np.ptp(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# The WKV recurrence
# ---------------------------------------------------------------------------

def _wkv_inputs(t: int):
    """r, k, v, w, u, S0 of 2 rows, 3 heads of 8 channels (the shapes of
    ``tests/test_rwkv_chunked.py``), w in (0.01, 0.99), a non-zero S0."""
    rng = np.random.default_rng(t)
    b, h, n = 2, 3, 8
    r, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.normal(size=(b, t, h, n)))) * 0.98
         + 0.01).astype(np.float32)
    u = (rng.normal(size=(h, n)) * 0.1).astype(np.float32)
    S0 = (rng.normal(size=(b, h, n, n)) * 0.5).astype(np.float32)
    return r, k, v, w, u, S0


@pytest.mark.parametrize("t,chunk", [(16, 8), (37, 16), (128, 64)])
def test_wkv_chunked_matches_reference_and_sequential(t, chunk):
    """The chunked WKV (37 steps: a ragged last chunk, padded with w = 1)
    equals the JAX package's ``_wkv_chunked`` within WKV_RTOL of the range
    and the port's sequential recurrence within SEQ_TOL, in y and in the
    final state."""
    arrs = _wkv_inputs(t)
    want_y, want_S = RS._wkv_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    ts = [torch.from_numpy(a) for a in arrs]
    y, S = SSM.wkv_chunked(*ts, chunk=chunk)
    _close(_np(y), want_y, WKV_RTOL)
    _close(_np(S), want_S, WKV_RTOL)
    ys, Ss = SSM.wkv_sequential(*ts)
    np.testing.assert_allclose(_np(y), _np(ys), rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(_np(S), _np(Ss), rtol=SEQ_TOL, atol=SEQ_TOL)


def test_softplus_is_the_reference_form():
    """``SSM.softplus`` is ``jax.nn.softplus`` (logaddexp(x, 0)) within two
    float32 ulps (torch's and XLA's exp and log1p differ in the last
    place), past 20 too, where ``F.softplus`` returns x: there the other
    term is below 2.1e-9, under half an ulp of x, so both forms give x
    exactly."""
    x = np.concatenate([np.linspace(-30, 30, 601),
                        [20.0, 20.5, 25.0, 88.0]]).astype(np.float32)
    got = _np(SSM.softplus(torch.from_numpy(x)))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-38)
    big = x >= 20
    np.testing.assert_array_equal(got[big], x[big])
    np.testing.assert_array_equal(
        _np(torch.nn.functional.softplus(torch.from_numpy(x[big]))), x[big])


# ---------------------------------------------------------------------------
# The mixers
# ---------------------------------------------------------------------------

def _mixer_params(mixer: str):
    """Layer 0's mixer params, JAX and port."""
    arch = "hymba-1.5b" if mixer == "mamba" else "rwkv6-3b"
    rcfg, pcfg, rparams, pparams = _arch(arch)
    key = "k0_hymba" if mixer == "mamba" else "k0_rwkv"
    rp = jax.tree.map(lambda t: t[0], rparams["blocks"][0])[key][mixer]
    pp = PT.map_leaves(lambda t: t[0], pparams["blocks"][0])[key][mixer]
    return rcfg, pcfg, rp, pp


def _mixer_inputs(mixer: str, s: int, stateful: bool):
    """x (2, s, 128) and the incoming state (numpy), or None."""
    rng = np.random.default_rng(100 * s + stateful)
    x = rng.normal(size=(2, s, 128)).astype(np.float32)
    if not stateful:
        return x, None
    f = lambda *shape: (rng.normal(size=shape) * 0.5).astype(np.float32)
    if mixer == "tmix":
        return x, {"S": f(2, 4, 32, 32), "xprev": f(2, 128)}
    if mixer == "cmix":
        return x, f(2, 128)
    return x, {"h": f(2, 128, 16), "conv": f(2, 3, 128)}


def _call(mixer, side, params, x, state, backend):
    """One mixer call on the JAX ("ref") or port side -> (out, state)."""
    arch = "hymba-1.5b" if mixer == "mamba" else "rwkv6-3b"
    rcfg, pcfg = _arch(arch)[:2]
    if side == "ref":
        q = RQ.for_lm(backend)
        if mixer == "tmix":
            return RS.rwkv_tmix(params, x, rcfg.rwkv_cfg(), DEFAULT_RULES, q,
                                state=state, chunked=rcfg.rwkv_chunked)
        if mixer == "cmix":
            return RS.rwkv_cmix(params, x, DEFAULT_RULES, q, xprev=state)
        return RS.mamba(params, x, rcfg.mamba_cfg(), DEFAULT_RULES, q,
                        state=state)
    q = for_lm(backend)
    with torch.no_grad():
        if mixer == "tmix":
            return SSM.rwkv_tmix(params, x, pcfg.rwkv_cfg(), q, state=state,
                                 chunked=pcfg.rwkv_chunked)
        if mixer == "cmix":
            return SSM.rwkv_cmix(params, x, q, xprev=state)
        return SSM.mamba(params, x, pcfg.mamba_cfg(), q, state=state)


def _leaves(out):
    """(output, state) -> {name: array} of the output and every state
    leaf."""
    y, st = out
    st = st if isinstance(st, dict) else {"xprev": st}
    conv = _np if isinstance(y, torch.Tensor) else (lambda a: a)
    return {"out": conv(y), **{k: conv(v) for k, v in st.items()}}


@functools.lru_cache(maxsize=None)
def _ref_mixer(mixer: str, backend: str, s: int, stateful: bool):
    """The JAX package's mixer on the case's inputs. Without a state it
    gets a zero one, which is what its ``state=None`` builds, so that one
    compiled function per shape serves both cases (the port's side runs
    ``state=None`` itself)."""
    _, _, rp, _ = _mixer_params(mixer)
    x, st = _mixer_inputs(mixer, s, stateful)
    if st is None:
        st = jax.tree.map(np.zeros_like, _mixer_inputs(mixer, s, True)[1])
    return _ref_fn(mixer, backend)(rp, jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, st))


@functools.lru_cache(maxsize=None)
def _ref_fn(mixer: str, backend: str):
    return jax.jit(lambda p, x, st: _leaves(_call(mixer, "ref", p, x, st,
                                                  backend)))


CASES = [(1, False), (1, True), (5, False), (5, True)]


@pytest.mark.parametrize("mixer", MIXERS)
@pytest.mark.parametrize("backend", ["bf16", "approx_lut",
                                     "approx_deficit_pallas"])
def test_mixer_matches_reference(mixer, backend):
    """rwkv_tmix (chunked WKV at s = 5, the sequential step at s = 1),
    rwkv_cmix and mamba, with and without an incoming state, at s = 1 and
    5: the output and every state leaf agree with the JAX package's within
    FLOAT_RTOL under bf16, within QUANT_RTOL under a quantized backend."""
    ref_backend = "bf16" if backend == "bf16" else "approx_lut"
    rtol = FLOAT_RTOL if backend == "bf16" else QUANT_RTOL
    _, _, _, pp = _mixer_params(mixer)
    for s, stateful in CASES:
        want = _ref_mixer(mixer, ref_backend, s, stateful)
        x, st = _mixer_inputs(mixer, s, stateful)
        st = None if st is None else (
            torch.from_numpy(st) if mixer == "cmix"
            else {k: torch.from_numpy(v) for k, v in st.items()})
        got = _leaves(_call(mixer, "port", pp, torch.from_numpy(x), st,
                            backend))
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].shape == want[name].shape, name
            _close(got[name], want[name], rtol)


N_PROJ = {"tmix": 5, "cmix": 3, "mamba": 3}


@pytest.mark.parametrize("mixer", MIXERS)
@pytest.mark.parametrize("backend", ["approx_lut", "approx_deficit_pallas"])
def test_mixer_codes_and_accumulators_bitwise(monkeypatch, mixer, backend):
    """Every quantized projection of a mixer call (5 tokens, with a state):
    on the same input rows and weights, the port's int8 codes and its
    int32 sums equal the JAX package's approx_lut codes and sums bit for
    bit; each input reaches the quantizer contiguous."""
    _, _, _, pp = _mixer_params(mixer)
    x, st = _mixer_inputs(mixer, 5, True)
    st = (torch.from_numpy(st) if mixer == "cmix"
          else {k: torch.from_numpy(v) for k, v in st.items()})
    calls = []
    inner = L.quantized_matmul

    def spy(x, w, cfg, bias=None, activation=None):
        assert x.is_contiguous()
        calls.append((x.detach().clone(), w.detach().clone()))
        return inner(x, w, cfg, bias=bias, activation=activation)

    monkeypatch.setattr(L, "quantized_matmul", spy)
    _call(mixer, "port", pp, torch.from_numpy(x), st, backend)
    assert len(calls) == N_PROJ[mixer]
    for i, (xi, w) in enumerate(calls):
        x2 = xi.reshape(-1, xi.shape[-1])
        xq, _ = quantize_dynamic(x2, axis=-1)
        wq, _ = quantize_dynamic(w, axis=0)
        acc = QM.integer_matmul(xq, wq.contiguous(), QuantConfig(backend))
        wxq, wacc = _jax_codes(jnp.asarray(_np(x2)), jnp.asarray(_np(w)))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(wxq),
                                      err_msg=f"projection {i} codes")
        np.testing.assert_array_equal(acc.numpy(), np.asarray(wacc),
                                      err_msg=f"projection {i} sums")


# ---------------------------------------------------------------------------
# The archs: decode against the cache-free forward, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill 8 tokens (rwkv6's chunked WKV; hymba's ring of 8 full),
    then decode one token at position 8: the logits equal those of a
    cache-free forward over all 9 tokens within DECODE_TOL (the JAX
    package's ``test_decode_matches_full_forward``)."""
    _, cfg, _, params = _arch(arch)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 9)))
    with torch.no_grad():
        cache = PT.init_cache(cfg, 2, 32, torch.float32, "cpu")
        _, cache = PT.prefill(params, toks[:, :8], cfg, cache)
        lg, _ = PT.decode_step(params, toks[:, 8:], 8, cfg, cache)
        h, _, _ = PT.backbone(params, PT.embed_tokens(params, toks, cfg),
                              cfg)
        ref = PT.lm_logits(params, h[:, -1:], cfg)
    assert float((lg - ref).abs().max()) < DECODE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_finite(arch):
    """``forward_loss`` of 2 x 12 tokens: a finite loss, every gradient
    finite and some non-zero (the JAX package's
    ``test_train_step_grads_finite``)."""
    _, cfg, _, params = _arch(arch)
    params = PT.map_leaves(lambda t: t.clone().requires_grad_(True), params)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 12)))
    loss = PT.forward_loss(params, {"tokens": toks, "labels": toks}, cfg)
    loss.backward()
    grads = []
    PT.map_leaves(lambda t: grads.append(t.grad), params)
    assert torch.isfinite(loss)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)

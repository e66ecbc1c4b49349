"""The port's stub embeddings and multi-codebook heads: musicgen-large at
``registry.reduced`` (2 layers, d_model 128, 4 heads of 32, a gelu MLP of
256, 4 codebooks over a vocab of 512, frame embeddings in place of token
ids) against the JAX package's, on the same numpy inputs; the weights are
the port's init at seed 0 (the reference's scales), passed to the JAX
package as numpy arrays and back through
``repro_torch.convert.params_from_jax``. Then what the two new
configurations share: ``convert`` of their new leaves in bfloat16, and
the serving engine's refusal of both (the reference's engine serves
neither).

Where the port runs ``approx_deficit_pallas`` the JAX side runs its oracle
``approx_lut`` (its own tests hold its Pallas entries to it bit for bit);
on the CPU the port's ``*_pallas`` backends run their kernels' plain
versions.

What is claimed, and within what:
  * the codebook head: (B, S, 4, V) float32 logits of a float einsum, the
    same under every backend and under QAT, within FLOAT_RTOL of the
    reference's on the same hidden states;
  * int8 codes and int32 accumulators of every quantized projection equal
    bit for bit on the same input rows (the head is float: none there);
  * the codebook loss and the logits under bf16 within FLOAT_RTOL; the
    logits under approx_deficit_pallas within QUANT_RTOL of their range
    (torch's gelu rounds otherwise than XLA's in last places, and a last
    place at a rounding boundary moves a later int8 code: ROADMAP queue
    C);
  * float32 decode steps within CACHE_FREE_RTOL of their range of a
    cache-free forward;
  * one QAT training step's loss and gradients, the float codebook table's
    included, within GRAD_RTOL * max(1, the leaf's largest) [a CPU run:
    below 1e-7], each channel's largest weight of the fake-quantized layer
    matrices left out (ROADMAP queue C);
  * ``make_serve_step``'s greedy codes (B, 4) equal the reference's.
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
from repro.quant import matmul as RQM
from repro.train import steps as RS

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import transformer_lm as PT
from repro_torch.nn import layers as L
from repro_torch.optim import adamw as AW
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig, for_lm, quantize_dynamic
from repro_torch.serve import Engine
from repro_torch.serve import __main__ as CLI
from repro_torch.train import steps as ST
from repro_torch.train.cnn_train import value_and_grad
from repro_torch.train.serve_loop import Server

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

ARCH = "musicgen-large"
FLOAT_RTOL = 1e-5
QUANT_RTOL = 2e-2
CACHE_FREE_RTOL = 1e-4
GRAD_RTOL = 1e-6
PROMPT, STEPS = 6, 4
NEW_ARCHS = ("llama-3.2-vision-11b", "musicgen-large")


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
    """(JAX cfg, port cfg, JAX params, port params) of the reduced
    musicgen."""
    rcfg, pcfg = RR.reduced(ARCH), PR.reduced(ARCH)
    arrays = params_to_numpy(PT.init(pcfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, arrays),
            params_from_jax(arrays, device="cpu"))


@functools.lru_cache(maxsize=None)
def _inputs():
    """Frame embeddings (2, PROMPT + STEPS, 128) and labels (2, PROMPT +
    STEPS, 4)."""
    rng = np.random.default_rng(7)
    cfg = _arch()[1]
    s = PROMPT + STEPS
    embeds = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, s, cfg.n_codebooks)
                          ).astype(np.int32)
    return embeds, labels


def test_tree_has_no_embedding_and_a_codebook_head():
    _, cfg, rparams, pparams = _arch()
    assert "embed" not in pparams and "embed" not in rparams
    assert tuple(pparams["lm_head"]["table"].shape) == (4, 512, 128)
    x = torch.from_numpy(_inputs()[0])
    assert PT.embed_tokens(pparams, x, cfg) is x


@pytest.mark.parametrize("backend", ["bf16", "approx_deficit_pallas"])
def test_codebook_head_is_float_and_matches_reference(backend):
    """(B, S, C, V) float32 logits of a float einsum over the (C, V, D)
    table: the same under a quantized backend and under QAT (no registry
    lowering, no fake-quant, no vocab mask), and within FLOAT_RTOL of the
    reference's on the same hidden states."""
    rcfg, cfg, rparams, pparams = _arch()
    h = np.random.default_rng(1).normal(size=(2, 5, 128)).astype(np.float32)
    cfg = dataclasses.replace(cfg, quant=for_lm(backend))
    got = PT.lm_logits(pparams, torch.from_numpy(h), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, 4, 512)
    assert torch.equal(got, PT.lm_logits(pparams, torch.from_numpy(h), cfg,
                                         qat=True))
    assert torch.equal(got, PT.lm_logits(
        pparams, torch.from_numpy(h), dataclasses.replace(
            cfg, quant=for_lm("bf16"))))
    want = RT.lm_logits(rparams, jnp.asarray(h), rcfg)
    _close(_np(got), want, FLOAT_RTOL)


def test_codebook_loss_matches_reference():
    """forward_loss over frame embeddings with (B, S, 4) labels, the mean
    over every (token, codebook), within FLOAT_RTOL of the reference's; it
    is the cross-entropy of the flattened (B * S * 4, V) logits."""
    rcfg, cfg, rparams, pparams = _arch()
    embeds, labels = _inputs()
    want = jax.jit(lambda p, e, y: RT.forward_loss(
        p, {"embeds": e, "labels": y}, rcfg))(
        rparams, jnp.asarray(embeds), jnp.asarray(labels))
    e, y = torch.from_numpy(embeds), torch.from_numpy(labels).long()
    with torch.no_grad():
        got = PT.forward_loss(pparams, {"embeds": e, "labels": y}, cfg)
        h, _, _ = PT.backbone(pparams, e, cfg)
        lg = PT.lm_logits(pparams, h, cfg)
        flat = L.softmax_cross_entropy(lg.reshape(-1, 512), y.reshape(-1))
    assert torch.equal(got, flat)
    assert abs(float(got) - float(want)) <= FLOAT_RTOL * abs(float(want))


DECODE_POS = [np.array([PROMPT + i, PROMPT + i]) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_logits(backend: str):
    """The JAX package's prefill of PROMPT frames and STEPS vector-position
    decode steps, one frame each: [logits rows (2, 1, 4, V)]."""
    rcfg, _, rparams, _ = _arch()
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    embeds = jnp.asarray(_inputs()[0])
    cache = RT.init_cache(cfg, 2, 16, jnp.float32)
    lg, cache = jax.jit(lambda p, e, c: RT.prefill(p, e, cfg, c))(
        rparams, embeds[:, :PROMPT], cache)
    out = [np.asarray(lg)]
    dec = jax.jit(lambda p, e, pos, c: RT.decode_step(p, e, pos, cfg, c))
    for i, pos in enumerate(DECODE_POS):
        lg, cache = dec(rparams, embeds[:, PROMPT + i:PROMPT + i + 1],
                        jnp.asarray(pos, jnp.int32), cache)
        out.append(np.asarray(lg))
    return out


@functools.lru_cache(maxsize=None)
def _port_logits(backend: str):
    _, pcfg, _, pparams = _arch()
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    embeds = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        cache = PT.init_cache(cfg, 2, 16, torch.float32, "cpu")
        lg, cache = PT.prefill(pparams, embeds[:, :PROMPT], cfg, cache)
        out = [_np(lg)]
        for i, pos in enumerate(DECODE_POS):
            lg, cache = PT.decode_step(
                pparams, embeds[:, PROMPT + i:PROMPT + i + 1],
                torch.from_numpy(pos), cfg, cache)
            out.append(_np(lg))
    return out


@pytest.mark.parametrize("backend", ["bf16", "approx_deficit_pallas"])
def test_prefill_decode_logits_match_reference(backend):
    """prefill over frame embeddings and the decode steps' (B, 1, 4, V)
    logits agree with the JAX package's within the backend's tolerance of
    their range."""
    ref = backend if backend == "bf16" else RQM.get_backend(backend).oracle
    want, got = _jax_logits(ref), _port_logits(backend)
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, 4, 512)
        _close(g, w, FLOAT_RTOL if backend == "bf16" else QUANT_RTOL)


def test_projection_codes_and_accumulators_bitwise(monkeypatch):
    """Every quantized projection of a prefill (q, k, v, o, the gelu MLP's
    up and down; the float head makes none): the port's
    approx_deficit_pallas codes and sums equal the JAX package's
    approx_lut ones bit for bit, on the same rows."""
    _, pcfg, _, pparams = _arch()
    cfg = dataclasses.replace(pcfg, quant=for_lm("approx_deficit_pallas"))
    calls = []
    inner = L.quantized_matmul

    def spy(x, w, c, bias=None, activation=None):
        calls.append((x.detach().clone(), w.detach().clone()))
        return inner(x, w, c, bias=bias, activation=activation)

    monkeypatch.setattr(L, "quantized_matmul", spy)
    with torch.no_grad():
        PT.prefill(pparams, torch.from_numpy(_inputs()[0][:1, :8]), cfg,
                   PT.init_cache(cfg, 1, 16, torch.float32, "cpu"))
    assert len(calls) == 6 * 2
    for i, (x, w) in enumerate(calls):
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
    xq, _ = RQ.quantize_dynamic(x, axis=-1)
    wq, _ = RQ.quantize_dynamic(w, axis=0)
    return xq, RQM.integer_matmul(xq, wq, RQ.QuantConfig("approx_lut"))


def test_decode_matches_cache_free_forward():
    """float32 weights under bf16: each decode step's logits within
    CACHE_FREE_RTOL of their range of a cache-free forward over all the
    frames."""
    _, cfg, _, pparams = _arch()
    embeds = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        h, _, _ = PT.backbone(pparams, embeds, cfg)
        ref = PT.lm_logits(pparams, h, cfg)
    for j, lg in enumerate(_port_logits("bf16")):
        _close(lg[:, 0], _np(ref[:, PROMPT - 1 + j]), CACHE_FREE_RTOL)


def test_qat_gradients_match_reference():
    """One QAT training step's loss and gradients over frame embeddings and
    codebook labels against ``jax.value_and_grad``; the codebook table
    (float in both packages) included."""
    rcfg, cfg, rparams, pparams = _arch()
    embeds, labels = _inputs()
    rl, rg = jax.jit(jax.value_and_grad(lambda p, b: RT.forward_loss(
        p, b, rcfg, qat=True, training=True)))(rparams, {
            "embeds": jnp.asarray(embeds), "labels": jnp.asarray(labels)})
    loss, grads = value_and_grad(
        lambda p, b: PT.forward_loss(p, b, cfg, qat=True, training=True),
        pparams, {"embeds": torch.from_numpy(embeds),
                  "labels": torch.from_numpy(labels).long()})
    assert abs(float(loss) - float(rl)) <= GRAD_RTOL * abs(float(rl))
    pairs, want = AW.flatten(grads), jax.tree.leaves(rg)
    assert ("lm_head", "table") in [p for p, _ in pairs]
    assert len(pairs) == len(want)
    for (path, g), w, w0 in zip(pairs, want, jax.tree.leaves(rparams)):
        w, w0 = np.asarray(w, np.float64), np.abs(np.asarray(w0))
        scale = float(np.abs(w).max())
        assert scale > 0, path
        keep = (w0 != w0.max(axis=1, keepdims=True)
                if path[0] == "blocks" and w0.ndim == 3
                else np.ones(w0.shape, bool))
        np.testing.assert_allclose(g.double().numpy()[keep], w[keep],
                                   rtol=0, atol=GRAD_RTOL * max(1.0, scale),
                                   err_msg=str(path))


def test_serve_step_codes_match_reference():
    """``make_serve_step`` after a prefill of the frames: one greedy code
    per codebook, (B, 4) int32, equal to the reference's serve step."""
    rcfg, cfg, rparams, pparams = _arch()
    embeds = _inputs()[0]
    with torch.no_grad():
        cache = PT.init_cache(cfg, 2, 16, torch.float32, "cpu")
        _, cache = PT.prefill(pparams, torch.from_numpy(embeds[:, :PROMPT]),
                              cfg, cache)
        nxt, _ = ST.make_serve_step(cfg)(
            pparams, cache, torch.from_numpy(embeds[:, PROMPT:PROMPT + 1]),
            PROMPT)
    rcache = RT.init_cache(rcfg, 2, 16, jnp.float32)
    _, rcache = jax.jit(lambda p, e, c: RT.prefill(p, e, rcfg, c))(
        rparams, jnp.asarray(embeds[:, :PROMPT]), rcache)
    rnxt, _ = jax.jit(RS.make_serve_step(rcfg))(
        rparams, rcache, jnp.asarray(embeds[:, PROMPT:PROMPT + 1]),
        jnp.int32(PROMPT))
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2, 4)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(rnxt))


# ---------------------------------------------------------------------------
# Both new configurations: convert, and the engine's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_convert_round_trips_the_new_leaves(arch):
    """bfloat16 trees of both configs (``enc_proj.w``, the (4, V, D)
    codebook table, a tree with no ``embed``) go to numpy, into JAX
    bfloat16 arrays with the reference's tree structure, and back through
    ``params_from_jax`` bit for bit."""
    rcfg = RR.reduced(arch, param_dtype=jnp.bfloat16)
    cfg = PR.reduced(arch, param_dtype=torch.bfloat16)
    params = PT.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    arrays = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          params_to_numpy(params))
    want = jax.eval_shape(lambda: RT.init(rcfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(arrays) == jax.tree.structure(want)
    back = params_from_jax(arrays, device="cpu")
    new = {"llama-3.2-vision-11b": ("enc_proj", "w"),
           "musicgen-large": ("lm_head", "table")}[arch]
    paths = [p for p, _ in AW.flatten(back)]
    assert new in paths and (("embed", "table") in paths) == (
        arch != "musicgen-large")
    for (path, a), (_, b) in zip(AW.flatten(back), AW.flatten(params)):
        assert a.dtype == b.dtype == torch.bfloat16, path
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), path
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), params_to_numpy(back), arrays)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("entry", ["engine", "server", "cli"])
def test_serving_refuses_the_new_archs(arch, entry):
    """The serving engine drives token models without encoder inputs, as
    the reference's does (it asserts on stub embeddings, and passes no
    encoder states to a cross layer): ``Engine``, ``Server`` and ``python
    -m repro_torch.serve --arch`` raise ValueError, the CLI before drawing
    any weight."""
    why = "stub embeddings" if arch == "musicgen-large" else "encoder states"
    if entry == "cli":
        with pytest.raises(ValueError, match=why):
            CLI.main(["--arch", arch, "--device", "cpu"])
        return
    cfg = PR.reduced(arch)
    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=why):
        if entry == "engine":
            Engine(cfg, params, slots=2, max_len=16, device="cpu")
        else:
            Server(cfg, params, batch_slots=2, max_len=16, device="cpu")

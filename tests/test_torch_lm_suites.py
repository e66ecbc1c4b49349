"""The port's ``lm`` and ``serve`` suites against the JAX package's, on
the JAX package's own weights carried across by ``repro_torch.convert``
(the two stacks' init RNGs differ, so each suite's own run trains or draws
other weights).

  * ``lm``: per backend, on 2 sequences of the suite's smoke eval stream,
    teacher-forced logits within LOGIT_RTOL of the reference
    ``repro.eval.lm.eval_point``'s range [3.1e-3 on a CPU run, drum6] and
    the loss within LOSS_RTOL [2.1e-7]; the port's rows carry those numbers
    (ppl to the JAX package's three decimals), every ``*_pallas`` row
    equals its oracle's, and the bf16 row is the reference of d_ppl and
    logit NMED. The float work around the int8 codes rounds differently in
    the two libraries; where that moves an activation across a rounding
    boundary its code moves one step, and under the truncating backends
    (drum6) one step of one operand moves a product by up to 2^k, which is
    why the bound is wider than the serving tests' 1e-5;
  * ``serve``: the smoke rows, on the weights the JAX package's suite draws
    (``TLM.init`` at key 0), equal the committed
    ``experiments/eval/serve.json`` rows for a representative subset of
    backends, every column, exactly. For the two lossy points of the
    subset (posneg, approx_lut[design13]) the JAX package as it runs today
    no longer reproduces its committed bf16-parity columns (posneg
    match_bf16 0.0, committed 5.56; design13 22.22 / 0.0, committed 16.67
    / 0.75; design13's spec_accept follows its tokens): for these two the
    port's tokens are held to the JAX package's sequential serve of the
    same workload today, match_bf16 and prefix_bf16 to what those tokens
    give, and the other columns but spec_accept to the artifact.
"""
import dataclasses
import functools
import importlib
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as RD
from repro.eval import lm as RL
from repro.models import transformer_lm as RT
from repro.quant import matmul as RQM

from repro_torch.convert import params_from_jax
from repro_torch.eval import lm as LM
from repro_torch.eval import serve as SERVE
from repro_torch.eval import runners as R
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import for_lm

torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")
COMMITTED = Path(__file__).resolve().parents[1] / "experiments" / "eval"
# logits within this share of the reference's range: int8 codes and
# accumulators are equal, the float work around them rounds differently
LOGIT_RTOL = 5e-3
LOSS_RTOL = 1e-5
EVAL_SEQS = 2
LM_BACKENDS = ("bf16", "int8_exact", "approx_lut", "approx_stage1", "msr4",
               "drum6", "posneg", "approx_deficit_pallas",
               "approx_stage1_pallas", "approx_rank1_pallas")
SERVE_POINTS = ("bf16", "int8_exact", "approx_lut", "approx_deficit_pallas",
                "approx_rank1_pallas", "posneg", "approx_lut[design13]")
# points whose bf16-parity columns the JAX package today computes
# otherwise than its committed artifact
RECOMPUTED = ("posneg", "approx_lut[design13]")


def _ref_backend(name):
    if name == "bf16":
        return name
    return RQM.get_backend(name).oracle or name


@functools.lru_cache(maxsize=None)
def _lm_case():
    """The lm suite's smoke arch and eval stream, the JAX package's weights
    at key 0."""
    rcfg = RL.arch(True)
    rparams = jax.tree.map(np.asarray, jax.jit(RT.init, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0)))
    b = LM.budgets(True)
    toks = RD.token_stream(b["eval_seqs"], b["seq"] + 1, rcfg.vocab,
                           seed=7)[:EVAL_SEQS]
    return rcfg, LM.arch(True), rparams, toks[:, :-1], toks[:, 1:]


@functools.lru_cache(maxsize=None)
def _jax_point(backend):
    rcfg, _, rparams, tokens, labels = _lm_case()
    lg, loss = RL.eval_point(rparams, rcfg, RQ.for_lm(backend),
                             jnp.asarray(tokens), jnp.asarray(labels))
    return np.asarray(lg), loss


def _sweep_of(labels):
    """``runners.sweep_points`` cut to ``labels`` (in sweep order)."""
    points = [p for p in R.sweep_points(variants=True) if p[0] in labels]
    return lambda variants=True: points


@functools.lru_cache(maxsize=None)
def _port_rows():
    _, pcfg, rparams, tokens, labels = _lm_case()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "sweep_points", _sweep_of(LM_BACKENDS))
        rows = LM.lm_rows(params_from_jax(rparams, device="cpu"), pcfg,
                          torch.from_numpy(tokens), torch.from_numpy(labels))
    return {r["backend"]: r for r in rows}


def test_lm_suite_config_matches_reference():
    for smoke in (True, False):
        rc, pc = RL.arch(smoke), LM.arch(smoke)
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "vocab_pad", "head_dim"):
            assert getattr(pc, f) == getattr(rc, f), f
        assert LM.budgets(smoke) == RL.budgets(smoke)


@pytest.mark.parametrize("backend", LM_BACKENDS)
def test_lm_eval_point_and_row_match_reference(backend):
    _, pcfg, rparams, tokens, labels = _lm_case()
    want_lg, want_loss = _jax_point(_ref_backend(backend))
    lg, loss = LM.eval_point(params_from_jax(rparams, device="cpu"), pcfg,
                             for_lm(backend), torch.from_numpy(tokens),
                             torch.from_numpy(labels))
    assert lg.shape == want_lg.shape and lg.dtype == torch.float32
    span = float(np.ptp(want_lg))
    np.testing.assert_allclose(lg.numpy(), want_lg, rtol=0,
                               atol=LOGIT_RTOL * span)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    row = _port_rows()[backend]
    assert row["ppl"] == round(math.exp(loss), 3)
    # the reference's ppl to its three decimals: one unit of rounding, and
    # what a loss within LOSS_RTOL moves it
    want_ppl = math.exp(want_loss)
    assert abs(row["ppl"] - round(want_ppl, 3)) <= \
        1e-3 + want_ppl * want_loss * LOSS_RTOL
    ref_lg, _ = _jax_point("bf16")
    nmed = RL.logit_nmed_pct(want_lg, ref_lg)
    assert abs(row["logit_nmed"] - nmed) <= 1e-2 * max(nmed, 0.01)


def test_lm_rows_pallas_equal_their_oracles():
    rows = _port_rows()
    assert list(rows) == [p[0] for p in R.sweep_points(variants=True)
                          if p[0] in LM_BACKENDS]
    assert rows["bf16"]["d_ppl"] == 0.0 and rows["bf16"]["logit_nmed"] == 0
    for name in QM.list_backends():
        oracle = QM.get_backend(name).oracle
        if name in rows and oracle in rows:
            for key in ("ppl", "d_ppl", "logit_nmed"):
                assert rows[name][key] == rows[oracle][key], (name, key)


def test_serve_smoke_rows_equal_committed_artifact(monkeypatch):
    """The serve suite's smoke workload and weights (the JAX package's draw
    at key 0, as its ``run`` makes them, not jitted), served by the port:
    every column of the subset's rows equals experiments/eval/serve.json."""
    rcfg = RL.arch(True)
    rparams = jax.tree.map(np.asarray, RT.init(rcfg, jax.random.PRNGKey(0)))
    reqs, slots, max_len = SERVE.workload(rcfg.vocab, True, 0)
    pparams = params_from_jax(rparams, device="cpu")
    monkeypatch.setattr(R, "sweep_points", _sweep_of(SERVE_POINTS))
    rows = SERVE.serve_rows(LM.arch(True), pparams, reqs, slots, max_len,
                            device="cpu")
    committed = json.loads((COMMITTED / "serve.json").read_text())
    want = {r["backend"]: r for r in committed["tables"]["serve"]}
    assert [r["backend"] for r in rows] == list(SERVE_POINTS)
    ref = _jax_served(rcfg, rparams, reqs, slots, max_len, "bf16")
    for row in rows:
        label = row["backend"]
        assert row["solo_match"] and row["spec_match"]
        if label not in RECOMPUTED:
            assert row == want[label], label
            continue
        for key in ("requests", "new_tokens", "hit_rate", "solo_match",
                    "spec_match"):
            assert row[key] == want[label][key], (label, key)
        # the JAX package's tokens today, and the columns they give
        from repro.eval import serve as RSV
        outs = _jax_served(rcfg, rparams, reqs, slots, max_len, label)
        backend, _, mult = label.rstrip("]").partition("[")
        got, _ = SERVE.serve_outputs(
            dataclasses.replace(LM.arch(True), quant=for_lm(
                backend, mult or "proposed")), pparams, reqs, slots,
            max_len, device="cpu")
        assert got == outs, label
        match_pct, prefix = RSV._parity(outs, ref)
        assert (row["match_bf16"], row["prefix_bf16"]) == (
            round(match_pct, 2), round(prefix, 2)), label


def _jax_served(cfg0, params, reqs, slots, max_len, label):
    """The JAX package's sequential serve of the workload under one sweep
    point -> {rid: tokens}."""
    from repro.eval import serve as RSV
    backend, _, mult = label.rstrip("]").partition("[")
    cfg = dataclasses.replace(cfg0, quant=RQ.for_lm(backend,
                                                     mult or "proposed"))
    return RSV.serve_outputs(cfg, params, reqs, slots, max_len)[0]


def test_serve_workload_matches_reference():
    from repro.eval import serve as RSV
    for smoke in (True, False):
        got, want = (m.workload(256, smoke, 0) for m in (SERVE, RSV))
        assert got[1:] == want[1:]
        for (rid, p, n), (wrid, wp, wn) in zip(got[0], want[0]):
            assert (rid, n) == (wrid, wn)
            np.testing.assert_array_equal(p, wp)
    assert SERVE._parity({}, {}) == (0.0, 0.0)
    assert SERVE._parity({0: [1, 2, 3]}, {0: [1, 2, 4]}) == \
        RSV._parity({0: [1, 2, 3]}, {0: [1, 2, 4]})
    assert dataclasses.asdict(SERVE.SPEC) == {
        "k": 4, "draft_backend": "approx_stage1", "draft_cfg": None}


def test_serve_suite_draft_on_the_card_is_approx_stage1_bitwise():
    """On the card the serve suite drafts through approx_stage1's CUDA twin,
    whose registered oracle is approx_stage1 (held bitwise to it on the card
    by chip_smoke.py's serve phase); elsewhere it drafts as SPEC says."""
    assert SERVE.spec_config("cpu") == SERVE.SPEC
    cuda = SERVE.spec_config("cuda")
    assert dataclasses.replace(cuda, draft_backend="approx_stage1") == \
        SERVE.SPEC
    assert QM.get_backend(cuda.draft_backend).oracle == \
        SERVE.SPEC.draft_backend

"""The port's examples and the modules of this slice, on the CPU, against
the JAX package where it has the same thing.

* ``examples.quickstart --device cpu`` prints the paper's Table-2 row
  (``ER=6.940%``) and the deficit identity (``identity OK``); its matmul's
  relative error equals the JAX package's ``quantized_matmul(...,
  approx_lut)`` on the same numpy inputs to 4 decimal places.
* ``examples.serve_lm`` (``python -m repro_torch.serve --reduced``) serves
  the same tokens with ``--spec-k 4`` as with ``--spec-k 0``.
* ``examples.denoise`` / ``examples.mnist_train`` hand the evaluation CLI
  their suite and the scratch directory; they train and sweep for minutes,
  as the JAX package's do (``tests/test_examples.py`` runs only its
  quickstart), so they run whole only on the card, in ``chip_smoke.py``.
* ``nn.conv.batchnorm`` equals the JAX package's in both modes within
  1e-6; ``python -m repro_torch.eval docs --check`` is green on the
  committed ``experiments/torch/eval/``; ``optim.adamw.init`` allocates
  exactly ``state_descs``; ``nn.attention.init_cache`` allocates on the
  card unless asked for another device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import conv as RC
from repro.quant import QuantConfig as RQuantConfig
from repro.quant import quantized_matmul as r_quantized_matmul

from repro_torch.configs import registry
from repro_torch.eval import cli as EVAL
from repro_torch.examples import denoise, mnist_train, quickstart, serve_lm
from repro_torch.launch import specs as SP
from repro_torch.models import transformer_lm as TLM
from repro_torch.nn import attention as A
from repro_torch.nn import conv as C
from repro_torch.optim import adamw

BN_TOL = 1e-6


def test_quickstart_on_the_cpu(capsys):
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "ER=6.940%" in out and "identity OK" in out
    assert got["identity_ok"] and got["pair"] == (255, 255)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 64)),
                    jnp.float32)
    w = jnp.asarray(np.random.default_rng(1).normal(size=(64, 8)),
                    jnp.float32)
    y = r_quantized_matmul(x, w, RQuantConfig(backend="approx_lut"))
    want = float(jnp.linalg.norm(y - x @ w) / jnp.linalg.norm(x @ w))
    assert round(got["rel"], 4) == round(want, 4), (got["rel"], want)
    assert f"{want:.4f}" in out


def test_serve_lm_speculative_tokens_equal_sequential(capsys):
    """The JAX example's promise: ``--spec-k`` changes the passes, never
    the served tokens (greedy, the bf16 draft)."""
    argv = ["--device", "cpu", "--requests", "4", "--max-new", "8"]
    seq = serve_lm.main(argv)
    spec = serve_lm.main(argv + ["--spec-k", "4"])
    out = capsys.readouterr().out
    assert spec["tokens"] == seq["tokens"] and len(seq["tokens"]) == 4
    assert spec["spec_passes"] > 0 and "spec_passes" not in seq
    assert "smollm-135m: 4 layers, d_model 128" in out
    assert "speculative K=4 draft=bf16" in out
    assert "tokens bitwise identical to --spec-k 0" in out


@pytest.mark.parametrize("example,suite", [(denoise, "denoise"),
                                           (mnist_train, "mnist")])
def test_suite_examples_run_their_suite_into_scratch(monkeypatch, example,
                                                      suite):
    calls = []
    monkeypatch.setattr(example, "eval_main",
                        lambda argv: calls.append(argv) or 1)
    assert example.main(["--smoke", "--device", "cpu"]) == 1
    assert calls == [["run", "--suite", suite, "--out",
                      str(EVAL.SCRATCH_OUT), "--device", "cpu", "--smoke"]]
    assert EVAL.SCRATCH_OUT.parts[-3:] == ("experiments", "torch", "scratch")


@pytest.mark.parametrize("training", (False, True))
def test_batchnorm_matches_reference(training):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6, 6, 8)).astype(np.float32) * 3 + 1
    params = {"scale": rng.normal(size=8), "bias": rng.normal(size=8),
              "mean": rng.normal(size=8), "var": rng.uniform(0.5, 2, 8)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    want, want_stats = RC.batchnorm({k: jnp.asarray(v) for k, v in
                                     params.items()}, jnp.asarray(x),
                                    training=training)
    got, stats = C.batchnorm({k: torch.from_numpy(v) for k, v in
                              params.items()}, torch.from_numpy(x),
                             training=training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BN_TOL * float(np.abs(want).max()))
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k].numpy(),
                                   np.asarray(want_stats[k]), rtol=BN_TOL,
                                   atol=BN_TOL)
    if not training:
        assert stats["mean"] is not None and np.array_equal(
            stats["var"].numpy(), params["var"])
    d = C.batchnorm_desc(8)
    assert {k: (v.shape, v.init) for k, v in d.items()} == {
        "scale": ((8,), "ones"), "bias": ((8,), "zeros"),
        "mean": ((8,), "zeros"), "var": ((8,), "ones")}


def test_docs_check_is_green_on_the_committed_artifacts(capsys):
    assert EVAL.main(["docs", "--check"]) == 0
    assert "match regenerated artifacts" in capsys.readouterr().out
    assert EVAL.DOCS_PATH.name == "reproduce_torch.md"


@pytest.mark.parametrize("quantized", (False, True))
def test_adamw_init_allocates_state_descs(quantized):
    cfg = registry.reduced("deepseek-v2-236b")
    params = TLM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ocfg = adamw.AdamWConfig(quantized_state=quantized)
    got = adamw.flatten(adamw.init(params, ocfg))
    want = adamw.flatten(SP.meta_tree(adamw.state_descs(TLM.descs(cfg),
                                                        ocfg)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path
        assert g.device.type == "cpu"
        fill = 1 if path[-1] == "v_scale" else 0
        assert bool((g == fill).all()), path


def test_attention_cache_is_on_the_card_by_default():
    acfg = registry.reduced("smollm-135m").attn_cfg()
    cpu = A.init_cache(acfg, 2, 8, torch.float32, "cpu")
    assert cpu["k"].shape == (2, 8, acfg.n_kv_heads, acfg.head_dim)
    if torch.cuda.is_available():
        assert A.init_cache(acfg, 2, 8)["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.init_cache(acfg, 2, 8)

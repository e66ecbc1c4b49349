"""The port's eval harness (repro_torch.eval) against the JAX package's
(repro.eval): the deterministic suites reproduce the committed
experiments/eval artifacts table for table; the sweep points, profile
columns, markdown and artifact schema are the same; the task sweeps on
fixed weights score every backend as the JAX package does.

Bounds on the task sweeps (no training here: the fixture's JAX-trained
LeNet-5 weights, and a small FFDNet drawn with numpy):
  * accuracy: equal, on one batch of N_TEST digits. The logits of the two
    stacks agree within 2e-3 of their range (tests/test_torch_fixture.py),
    which moves no argmax on these digits.
  * PSNR within PSNR_TOL dB and SSIM within SSIM_TOL, after the rows'
    rounding to 2 and 4 decimals: the float32 pools, epilogues and
    convolutions of the two stacks round differently in the last place.
Each JAX row is the JAX package's score for the point's oracle: its own
tests hold every backend bit-identical to its oracle, so the oracles are
the only distinct JAX paths (and no Pallas kernel is interpreted at model
size). Each port *_pallas row must equal its oracle's row exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.eval import artifacts as RART
from repro.eval import markdown as RMD
from repro.eval import profiles as RPROF
from repro.eval import runners as RR
from repro.models import cnn as RCNN
from repro.quant import matmul as RQM
from repro.train import cnn_train as RT

from repro_torch.convert import params_from_jax
from repro_torch.eval import artifacts, markdown, profiles
from repro_torch.eval import runners as R
from repro_torch.eval.cli import DEFAULT_OUT, main
from repro_torch.models import cnn as CNN

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "experiments" / "eval"
FIXTURE = ROOT / "src" / "repro_torch" / "testdata" / "reference.npz"
N_TEST = 20
PSNR_TOL = 0.02
SSIM_TOL = 2e-4
TASK_KEYS = {"mnist": ("acc",), "denoise": ("psnr", "ssim", "noisy_psnr")}


def _ref_backend(backend: str) -> str:
    if backend == "bf16":
        return backend
    return RQM.get_backend(backend).oracle or backend


def _fixture_lenet():
    tree: dict = {}
    with np.load(FIXTURE) as data:
        for key in data.files:
            if key.startswith("lenet5/"):
                _, layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = data[key]
    return tree


def _ffdnet_params():
    rng = np.random.default_rng(6)
    descs = RCNN.ffdnet_descs(RCNN.FFDNetConfig(depth=3, width=8))
    return {layer: {leaf: (rng.normal(size=d.shape) * (
        0.05 if d.init == "zeros" else int(np.prod(d.shape[:-1])) ** -0.5))
        .astype(np.float32) for leaf, d in leaves.items()}
        for layer, leaves in descs.items()}


# ---------------------------------------------------------------------------
# deterministic suites, sweep points, profiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suite", ["metrics", "hw"])
def test_deterministic_suites_reproduce_committed_tables(suite):
    art = R.SUITES[suite].run(device="cpu")
    committed = json.loads((COMMITTED / f"{suite}.json").read_text())
    assert art["tables"] == committed["tables"]
    assert R.render_artifact(art) == (COMMITTED / f"{suite}.md").read_text()
    assert art["config"]["device"] == "cpu"
    assert art["config"]["torch"] == torch.__version__


def test_table2_proposed_row():
    row = next(r for r in R.SUITES["metrics"].run(device="cpu")
               ["tables"]["table2"] if r["design"] == "proposed")
    assert (row["er"], row["nmed"], row["mred"]) == (6.94, 0.046, 0.109)


def test_sweep_points_equal_reference():
    assert R.sweep_points() == RR.sweep_points()
    assert R.sweep_points(variants=False) == RR.sweep_points(variants=False)
    assert len(R.sweep_points()) == 18


def test_backend_profiles_equal_reference():
    for _, backend, mult in R.sweep_points():
        assert profiles.backend_profile(backend, mult) == \
            RPROF.backend_profile(backend, mult), (backend, mult)
        assert profiles.correction_cost(backend, mult) == \
            RPROF.correction_cost(backend, mult)


def test_suite_tables_and_order():
    assert R.SUITE_ORDER == ("metrics", "hw", "denoise", "mnist", "lm",
                             "serve")
    assert R.SUITE_ORDER == RR.SUITE_ORDER
    for name in R.SUITE_ORDER:
        assert list(R.SUITES[name].tables) == list(RR.SUITES[name].tables)
        for tname, spec in R.SUITES[name].tables.items():
            ref = RR.SUITES[name].tables[tname]
            assert (spec.title, spec.columns) == (ref.title, ref.columns)
            # the task tables' notes drop the JAX package's parenthesis
            # on why its data are synthetic, and the LM tables' notes its
            # pointers to its own docs, tests and benchmarks; the rest is
            # the same text
            assert spec.note == ref.note or name in (*TASK_KEYS, "lm",
                                                     "serve")


def test_resolve_suites():
    assert R.resolve_suites("all") == R.SUITE_ORDER
    assert R.resolve_suites(" hw , metrics ") == ("hw", "metrics")
    for bad in ("metrics,nope", ","):
        with pytest.raises(KeyError, match="unknown suite"):
            R.resolve_suites(bad)
    assert R.resolve_suites("all") == ("metrics", "hw", "denoise", "mnist",
                                       "lm", "serve")
    assert R.resolve_suites("lm,serve") == ("lm", "serve")
    assert R.resolve_suites("serve, lm") == ("serve", "lm")


# ---------------------------------------------------------------------------
# task sweeps on fixed weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist_rows():
    params = _fixture_lenet()
    ours = R.mnist_rows(params_from_jax(params, device="cpu"),
                        n_test=N_TEST, seed=0, device="cpu")
    ref = {}
    for label, backend, mult in R.sweep_points():
        key = (_ref_backend(backend), mult)
        if key not in ref:
            ref[key] = RT.eval_classifier(
                params, RCNN.lenet5_apply, RR.quant_for(*key),
                n_test=N_TEST, seed=1)
    return ours, ref


def test_mnist_rows_match_reference(mnist_rows):
    ours, ref = mnist_rows
    assert [r["backend"] for r in ours] == [p[0] for p in R.sweep_points()]
    for row, (label, backend, mult) in zip(ours, R.sweep_points()):
        assert row["acc"] == round(ref[(_ref_backend(backend), mult)], 2), \
            label
        assert {k: v for k, v in row.items() if k not in ("backend", "acc")} \
            == RPROF.backend_profile(backend, mult)
    assert next(r["acc"] for r in ours if r["backend"] == "bf16") >= 90.0


def _oracle_rows_equal(rows, keys):
    by = {(r["backend"], r.get("sigma")): r for r in rows}
    pallas = [r for r in rows if r["backend"].endswith("_pallas")]
    assert len(pallas) == 3 * len({r.get("sigma") for r in rows})
    for row in pallas:
        oracle = RQM.get_backend(row["backend"]).oracle
        want = by[(oracle, row.get("sigma"))]
        assert [row[k] for k in keys] == [want[k] for k in keys], \
            row["backend"]


def test_mnist_pallas_rows_equal_oracle_rows(mnist_rows):
    _oracle_rows_equal(mnist_rows[0], TASK_KEYS["mnist"])


@pytest.fixture(scope="module")
def denoise_rows():
    params = _ffdnet_params()
    cfg = CNN.FFDNetConfig(depth=3, width=8)
    rcfg = RCNN.FFDNetConfig(depth=3, width=8)
    kw = dict(n=2, size=16, seed=3)
    ours = R.denoise_rows(params_from_jax(params, device="cpu"), cfg,
                          sigmas=(25.0, 50.0), n_eval=2, size=16, seed=0,
                          device="cpu")
    ref = {}
    for sigma in (25.0, 50.0):
        for _, backend, mult in R.sweep_points():
            key = (_ref_backend(backend), mult, sigma)
            if key not in ref:
                ref[key] = RT.eval_denoiser(
                    params, rcfg, RR.quant_for(*key[:2]), sigma=sigma, **kw)
    return ours, ref


def test_denoise_rows_match_reference(denoise_rows):
    ours, ref = denoise_rows
    points = [(s, p) for s in (25.0, 50.0) for p in R.sweep_points()]
    assert len(ours) == len(points)
    for row, (sigma, (label, backend, mult)) in zip(ours, points):
        assert (row["backend"], row["sigma"]) == (label, sigma)
        psnr, ssim, noisy = ref[(_ref_backend(backend), mult, sigma)]
        assert abs(row["psnr"] - psnr) <= PSNR_TOL, (label, sigma)
        assert abs(row["ssim"] - ssim) <= SSIM_TOL, (label, sigma)
        assert abs(row["noisy_psnr"] - noisy) <= PSNR_TOL
        assert {k: v for k, v in row.items() if k not in
                ("backend", "sigma", "psnr", "ssim", "noisy_psnr")} == \
            RPROF.backend_profile(backend, mult)


def test_denoise_pallas_rows_equal_oracle_rows(denoise_rows):
    _oracle_rows_equal(denoise_rows[0], TASK_KEYS["denoise"])


# ---------------------------------------------------------------------------
# markdown and artifacts
# ---------------------------------------------------------------------------

def test_markdown_table_same_bytes_as_reference():
    rows = [{"a": 1, "b": 2.3456, "c": None}, {"a": "x", "b": 0.5}]
    cols = (("a", "A", None), ("b", "B", ".2f"), ("c", "C", ".1f"))
    assert markdown.markdown_table(rows, cols) == \
        RMD.markdown_table(rows, cols)
    text = "pre\n<!-- eval:t:begin -->\nold\n<!-- eval:t:end -->\npost"
    assert markdown.inject_block(text, "t", "new\n") == \
        RMD.inject_block(text, "t", "new\n")
    assert markdown.block_names(text) == RMD.block_names(text) == ["t"]


def test_artifact_roundtrip(tmp_path):
    art = artifacts.make_artifact(
        "demo", {"t": [{"a": 1, "b": 2.5, "c": None, "d": "x"}]},
        {"smoke": True, "seed": 0})
    path = tmp_path / "demo.json"
    artifacts.save(path, art)
    assert artifacts.load(path) == art
    assert artifacts.SCHEMA_VERSION == RART.SCHEMA_VERSION
    RART.validate(art)


def test_artifact_validation_rejects_bad_schemas():
    good = artifacts.make_artifact("demo", {"t": [{"a": 1}]}, {})
    for bad in ({**good, "schema_version": 999},
                {k: v for k, v in good.items() if k != "tables"},
                {**good, "tables": {}},
                {**good, "tables": {"t": [{"a": [1, 2]}]}},
                {**good, "tables": {"t": "not-rows"}},
                {**good, "suite": ""}, {**good, "config": []}, []):
        with pytest.raises(ValueError):
            artifacts.validate(bad)
        with pytest.raises(ValueError):
            RART.validate(bad)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_run_and_render_on_cpu(tmp_path):
    assert main(["run", "--suite", "metrics,hw", "--device", "cpu",
                 "--out", str(tmp_path)]) == 0
    for suite in ("metrics", "hw"):
        art = artifacts.load(tmp_path / f"{suite}.json")
        committed = json.loads((COMMITTED / f"{suite}.json").read_text())
        assert art["tables"] == committed["tables"]
        md = (tmp_path / f"{suite}.md").read_text()
        (tmp_path / f"{suite}.md").unlink()
        assert main(["render", "--suite", suite, "--out",
                     str(tmp_path)]) == 0
        assert (tmp_path / f"{suite}.md").read_text() == md
    assert main(["render", "--suite", "mnist", "--out", str(tmp_path)]) == 1
    assert main(["run", "--suite", "nope", "--out", str(tmp_path)]) == 2
    assert DEFAULT_OUT == ROOT / "experiments" / "torch" / "eval"


def test_cli_run_reports_a_failing_suite(tmp_path, monkeypatch):
    def boom(smoke=False, seed=0, device="cuda"):
        raise RuntimeError("injected suite failure")

    monkeypatch.setitem(R.SUITES, "boom", R.Suite("boom", boom, {}))
    monkeypatch.setattr(R, "SUITE_ORDER", ("boom", "metrics"))
    assert main(["run", "--suite", "all", "--device", "cpu",
                 "--out", str(tmp_path)]) == 1
    assert (tmp_path / "metrics.json").exists()
    assert not (tmp_path / "boom.json").exists()


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    assert main(["run", "--suite", "metrics", "--out", str(tmp_path)]) == 1
    assert not (tmp_path / "metrics.json").exists()


def test_module_entrypoint_lists_backends():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.eval",
                          "backends"], env=env, capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-1500:]
    names = [line.split()[0] for line in out.stdout.splitlines()]
    assert names == list(RQM.list_backends())

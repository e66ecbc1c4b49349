"""The reference fixture that holds the CUDA port to the JAX package on a
machine without JAX (src/repro_torch/testdata/reference.npz).

It holds, all made by the JAX package on the CPU:
  * int8 operand pairs at shapes that cross the CUDA kernels' 64x64x32
    tiles, with every registered slice backend's int32 output;
  * LeNet-5 weights trained by the mnist suite's smoke recipe (60 QAT
    steps on 1500 synthetic digits, seed 0);
  * the logits of the first 50 test digits and the accuracy on 500 under
    int8_exact, approx_lut and approx_stage1, in eval_classifier's batches
    of 50 (its accuracy is computed from the same logits).

``make_reference`` writes it (``PYTHONPATH=src python
tests/test_torch_fixture.py``); the tests recompute every output from the
committed weights and operands, without retraining, and hold the port to
it on the CPU. chip_smoke.py holds the card to it.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_refs as REFS
import torch

from repro.data import synthetic
from repro.models import cnn as JCNN
from repro.quant.quantize import QuantConfig as JQuantConfig
from repro.train import cnn_train as JT

from repro_torch.convert import params_from_jax
from repro_torch.models import cnn as CNN
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig
from repro_torch.train import cnn_train as T

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

FIXTURE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "testdata" / "reference.npz")
SHAPES = ((3, 1, 1), (70, 65, 66))
MODEL_BACKENDS = ("int8_exact", "approx_lut", "approx_stage1")
N_LOGITS = 50
N_TEST = 500
# Float bound on logits between the two stacks: the int8 codes and int32
# accumulators agree bitwise; the float32 epilogues and average pools may
# round differently in the last place, which can move a later layer's
# code by one step. 2e-3 of the logits' range covers that with margin.
LOGIT_RTOL = 2e-3


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    return (rng.integers(-127, 128, (m, k)).astype(np.int8),
            rng.integers(-127, 128, (k, n)).astype(np.int8))


def _jax_backend_outputs(x, w):
    return {name: np.asarray(REFS.integer_matmul(
        jnp.asarray(x), jnp.asarray(w), JQuantConfig(backend=name)))
        for name in QM.list_backends()}


def _jax_model_outputs(params):
    """JAX's logits on the first batch and accuracy on N_TEST digits, in
    eval_classifier's batches of N_LOGITS (the activation scale is
    per batch, so the first batch's logits are eval_classifier's own)."""
    imgs, labels = synthetic.digits(N_TEST, seed=1)
    out = {}
    for name in MODEL_BACKENDS:
        fn = jax.jit(functools.partial(JCNN.lenet5_apply,
                                       quant=JQuantConfig(backend=name)))
        logits = np.concatenate([
            np.asarray(fn(params, jnp.asarray(imgs[i:i + N_LOGITS])))
            for i in range(0, N_TEST, N_LOGITS)])
        out[f"logits_{name}"] = logits[:N_LOGITS]
        out[f"acc_{name}"] = np.float64(
            100.0 * int((logits.argmax(-1) == labels).sum()) / N_TEST)
    return out


def _flatten(params, prefix="lenet5"):
    return {f"{prefix}/{layer}/{leaf}": np.asarray(v)
            for layer, leaves in params.items()
            for leaf, v in leaves.items()}


def load_lenet5(data) -> dict:
    tree: dict = {}
    for key in data.files:
        if key.startswith("lenet5/"):
            _, layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = data[key]
    return tree


def make_reference(path: Path = FIXTURE) -> None:
    arrays = {}
    for i, shape in enumerate(SHAPES):
        x, w = _operands(shape, seed=100 + i)
        arrays[f"x{i}"], arrays[f"w{i}"] = x, w
        for name, out in _jax_backend_outputs(x, w).items():
            arrays[f"out{i}_{name}"] = out
    params = JT.train_classifier(JCNN.lenet5_descs(), JCNN.lenet5_apply,
                                 steps=60, n_train=1500, seed=0, qat=True)
    params = jax.tree.map(np.asarray, params)
    arrays.update(_flatten(params))
    arrays.update(_jax_model_outputs(params))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as data:
        return {k: data[k] for k in data.files}, load_lenet5(data)


def test_fixture_is_small():
    assert FIXTURE.stat().st_size <= 1 << 20


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_fixture_operands_match_jax(ref, i):
    arrays, _ = ref
    x, w = arrays[f"x{i}"], arrays[f"w{i}"]
    assert x.shape == SHAPES[i][:2] and w.shape == SHAPES[i][1:]
    for name, out in _jax_backend_outputs(x, w).items():
        np.testing.assert_array_equal(out, arrays[f"out{i}_{name}"], name)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_port_backends_match_fixture(ref, i):
    """Bitwise int32 per backend, on the CPU."""
    arrays, _ = ref
    x = torch.from_numpy(arrays[f"x{i}"])
    w = torch.from_numpy(arrays[f"w{i}"])
    for name in QM.list_backends():
        got = QM.integer_matmul(x, w, QuantConfig(backend=name))
        np.testing.assert_array_equal(got.numpy(), arrays[f"out{i}_{name}"],
                                      name)


def test_fixture_model_outputs_match_jax(ref):
    arrays, params = ref
    for key, val in _jax_model_outputs(params).items():
        np.testing.assert_array_equal(val, arrays[key], key)


@pytest.mark.parametrize("backend", MODEL_BACKENDS)
def test_port_lenet5_matches_fixture(ref, backend):
    """Logits within LOGIT_RTOL of their range; accuracy equal."""
    arrays, params = ref
    tp = params_from_jax(params, device="cpu")
    q = QuantConfig(backend=backend)
    logits, labels = T.classifier_logits(tp, CNN.lenet5_apply, q,
                                         n_test=N_TEST, device="cpu")
    want = arrays[f"logits_{backend}"]
    bound = LOGIT_RTOL * float(np.abs(want).max())
    assert float(np.abs(logits[:N_LOGITS].numpy() - want).max()) <= bound
    acc = 100.0 * int((logits.argmax(-1) == labels).sum()) / N_TEST
    assert acc == float(arrays[f"acc_{backend}"])


if __name__ == "__main__":
    make_reference()
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

"""The port's quantization and backend registry against the JAX package's
(repro.quant). int8 codes and int32 accumulators are compared bitwise;
float outputs of quantized_matmul within FLOAT_RTOL of their range (the
JAX side may contract the dequant multiply and bias add into one FMA under
jit; the port rounds each)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_refs as REFS
import torch

import importlib

from repro.quant import matmul as RQM

from repro_torch.core import luts, truncation
from repro_torch.core.multiplier import proposed_multiplier
from repro_torch.quant import matmul as QM
from repro_torch.quant import quantize as Q

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

FLOAT_RTOL = 1e-6
BACKENDS = QM.list_backends()
FUSED = [n for n in BACKENDS if QM.get_backend(n).fused]
RNG = np.random.default_rng(5)
# the module, not the function repro.quant re-exports under its name
RQ = importlib.import_module("repro.quant.quantize")


def _q(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


def _close(got: torch.Tensor, want, rtol=FLOAT_RTOL):
    want = np.asarray(want)
    bound = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)


def test_registry_order_and_rules():
    """The JAX package's 15 backends, in its registration order, with the
    same oracles, fused entries and backward rule."""
    assert BACKENDS == RQM.list_backends()
    assert BACKENDS[9:] == ("msr4_lut", "msr4", "drum6_lut", "drum6",
                            "posneg_lut", "posneg")
    assert len(BACKENDS) == 15
    for name in BACKENDS:
        assert QM.get_backend(name).oracle == RQM.get_backend(name).oracle
        assert (QM.get_backend(name).fused is None) == (
            RQM.get_backend(name).fused is None)
        assert QM.get_backend(name).grad == RQM.get_backend(name).grad \
            == "ste"
    assert list(QM.backend_notes()) == list(BACKENDS)
    with pytest.raises(ValueError, match="unknown grad rule"):
        QM.register_backend("no_grad", lambda x, w, c: None, grad="exact")
    assert "no_grad" not in QM.list_backends()
    with pytest.raises(KeyError, match="unknown quant backend"):
        QM.get_backend("no_such_backend")
    with pytest.raises(ValueError, match="already registered"):
        QM.register_backend("int8_exact", lambda x, w, c: None)
    with pytest.raises(ValueError, match="unknown oracle"):
        QM.register_backend("dangling", lambda x, w, c: None,
                            oracle="no_such_backend")
    assert "dangling" not in QM.list_backends()


def test_quant_config_fields_and_presets():
    ours = [(f.name, f.default) for f in dataclasses.fields(Q.QuantConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(RQ.QuantConfig)]
    assert ours == ref
    for preset in ("BF16", "INT8", "APPROX_LUT", "APPROX_DEFICIT",
                   "APPROX_STAGE1", "APPROX_RANK1", "APPROX_DEFICIT_PALLAS",
                   "APPROX_STAGE1_PALLAS", "APPROX_RANK1_PALLAS", "MSR4",
                   "DRUM6", "POSNEG"):
        assert dataclasses.asdict(getattr(Q, preset)) == \
            dataclasses.asdict(getattr(RQ, preset))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
@pytest.mark.parametrize("axis", [None, 0, -1])
def test_quantize_codes_bitwise_random(scale, axis):
    x = (RNG.normal(size=(23, 17)) * scale).astype(np.float32)
    q, s = Q.quantize_dynamic(torch.from_numpy(x), axis=axis)
    rq, rs = RQ.quantize_dynamic(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8


def test_quantize_codes_bitwise_ties():
    """Exact .5 ties round half to even in both packages, then clip."""
    scale = np.float32(0.25)
    k = np.arange(-140, 140, dtype=np.float32)
    x = ((k + 0.5) * scale).astype(np.float32)
    q = Q.quantize(torch.from_numpy(x), torch.tensor(scale))
    rq = RQ.quantize(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(q.numpy(),
                                  np.clip(np.round(k + 0.5), -127, 127))


@pytest.mark.parametrize("shape", [(1, 1, 1), (9, 31, 17)])
@pytest.mark.parametrize("name", BACKENDS)
def test_backend_int32_matches_reference(name, shape):
    """Bitwise against the same-named JAX backend (its *_pallas entries in
    interpret mode)."""
    m, k, n = shape
    x, w = _q(m, k), _q(k, n)
    got = QM.integer_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            Q.QuantConfig(backend=name))
    want = REFS.integer_matmul(jnp.asarray(x), jnp.asarray(w),
                               RQ.QuantConfig(backend=name))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("design", ["design13"])
@pytest.mark.parametrize("name", ["approx_lut", "approx_rank1",
                                  "approx_deficit_pallas",
                                  "approx_rank1_pallas"])
def test_backend_designs_match_reference(name, design):
    x, w = _q(7, 12), _q(12, 5)
    cfg = Q.QuantConfig(backend=name, multiplier=design)
    got = QM.integer_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg)
    want = REFS.integer_matmul(jnp.asarray(x), jnp.asarray(w),
                               RQ.QuantConfig(backend=name,
                                              multiplier=design))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _oracle_table(name):
    """The signed (256, 256) product table a backend must reproduce."""
    sv = np.where(np.arange(256) < 128, np.arange(256), np.arange(256) - 256)
    if name == "int8_exact":
        return sv[:, None] * sv[None, :]
    if "stage1" in name:
        mag = np.abs(sv)
        sgn = np.sign(sv)[:, None] * np.sign(sv)[None, :]
        return QM.stage1_exhaustive_products()[mag[:, None], mag[None, :]] \
            * sgn
    kind = name.split("_")[0]
    if kind in truncation.KINDS:
        return truncation.product_table(kind)
    return luts.signed_product_lut(proposed_multiplier())


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_matches_oracle_on_all_pairs(name):
    """All 2^16 signed byte pairs at K = 1 against the numpy tables."""
    b = torch.arange(256, dtype=torch.int32).to(torch.int8)
    got = QM.integer_matmul(b.reshape(256, 1), b.reshape(1, 256),
                            Q.QuantConfig(backend=name))
    np.testing.assert_array_equal(got.numpy(), _oracle_table(name))


@pytest.mark.parametrize("name", FUSED)
def test_fused_equals_unfused_and_batched_equals_flat(name):
    """Bitwise: the fused epilogue rounds as the unfused composition, and a
    leading batch dim is the same rows as the flattened call."""
    x = torch.from_numpy(RNG.normal(size=(3, 7, 20)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(20, 11)).astype(np.float32))
    b = torch.from_numpy(RNG.normal(size=(11,)).astype(np.float32))
    cfg = Q.QuantConfig(backend=name)
    unfused = dataclasses.replace(cfg, fuse_epilogue=False)
    for act_scale in ("per_tensor", "per_token"):
        c = dataclasses.replace(cfg, act_scale=act_scale)
        u = dataclasses.replace(unfused, act_scale=act_scale)
        for bias, act in ((None, None), (b, "relu")):
            y = QM.quantized_matmul(x, w, c, bias=bias, activation=act)
            assert torch.equal(y, QM.quantized_matmul(x, w, u, bias=bias,
                                                      activation=act))
    for c in (cfg, dataclasses.replace(cfg, act_scale="per_token")):
        y = QM.quantized_matmul(x, w, c, bias=b, activation="relu")
        flat = QM.quantized_matmul(x.reshape(21, 20), w, c, bias=b,
                                   activation="relu")
        assert torch.equal(y.reshape(21, 11), flat)


@pytest.mark.parametrize("act_scale", ["per_tensor", "per_token"])
@pytest.mark.parametrize("name", BACKENDS)
def test_quantized_matmul_matches_reference(name, act_scale):
    x = RNG.normal(size=(2, 5, 24)).astype(np.float32)
    w = (RNG.normal(size=(24, 6)) * 0.2).astype(np.float32)
    b = RNG.normal(size=(6,)).astype(np.float32)
    got = QM.quantized_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        Q.QuantConfig(backend=name, act_scale=act_scale),
        bias=torch.from_numpy(b), activation="relu")
    want = RQM.quantized_matmul(
        jnp.asarray(x), jnp.asarray(w),
        RQ.QuantConfig(backend=name, act_scale=act_scale),
        bias=jnp.asarray(b), activation="relu")
    _close(got, want)


def test_quantized_matmul_rejects_bad_options():
    x, w = torch.zeros(2, 4), torch.ones(4, 3)
    with pytest.raises(ValueError, match="activation"):
        QM.quantized_matmul(x, w, Q.INT8, activation="gelu")
    with pytest.raises(ValueError, match="act_scale"):
        QM.quantized_matmul(x, w, Q.QuantConfig(backend="int8_exact",
                                                act_scale="per_row"))

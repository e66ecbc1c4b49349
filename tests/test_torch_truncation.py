"""The port's MSR/truncation family (repro_torch.core.truncation,
repro_torch.quant.truncated and the six registry entries) and its
hardware proxies (repro_torch.core.hwproxy) against the JAX package's.

Everything here is integer or exact: gate tables over all 2^16 signed
pairs, int8 decodes and int32 accumulators are compared bitwise, and the
unit-gate proxies value for value.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_refs as REFS
import torch

from repro.core import hwproxy as RHW
from repro.core import truncation as RT
from repro.quant import truncated as RTQ

from repro_torch.core import hwproxy as HW
from repro_torch.core import truncation as T
from repro_torch.quant import matmul as QM
from repro_torch.quant import truncated as TQ
from repro_torch.quant.quantize import QuantConfig

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")
FAMILY = [("msr4_lut", "msr4"), ("msr4", "msr4"),
          ("drum6_lut", "drum6"), ("drum6", "drum6"),
          ("posneg_lut", "posneg"), ("posneg", "posneg")]
CORES = [name for name, _ in FAMILY if not name.endswith("_lut")]
# all 256 signed int8 values in byte order: the K = 1 outer product covers
# every signed pair once, -128 and the all-same-bit bytes 0 and -1 too
BYTES = torch.arange(256, dtype=torch.int32).to(torch.int8)
RNG = np.random.default_rng(31)


@pytest.mark.parametrize("kind", T.KINDS)
def test_product_and_error_tables_equal_reference(kind):
    """Over all 2^16 signed pairs, and their error tables and summary."""
    np.testing.assert_array_equal(T.product_table(kind),
                                  RT.product_table(kind))
    np.testing.assert_array_equal(T.error_table(kind), RT.error_table(kind))
    assert T.product_table(kind).dtype == RT.product_table(kind).dtype
    assert T.table_stats(kind) == RT.table_stats(kind)


def test_bit_primitives_equal_reference():
    v = np.arange(-128, 128)
    mag = np.arange(256)
    np.testing.assert_array_equal(T.leading_one_pos(mag),
                                  RT.leading_one_pos(mag))
    np.testing.assert_array_equal(T.msr_run_length(v), RT.msr_run_length(v))
    np.testing.assert_array_equal(T.msr4_decode_value(v),
                                  RT.msr4_decode_value(v))
    for k in range(2, 9):
        np.testing.assert_array_equal(T.drum_truncate(mag, k),
                                      RT.drum_truncate(mag, k))
        np.testing.assert_array_equal(T.floor_truncate(mag, k),
                                      RT.floor_truncate(mag, k))
    w = RNG.integers(-128, 128, (9, 40)).astype(np.int8)
    ours, ref = T.msr4_encode(w), RT.msr4_encode(w)
    for field in ("mantissa", "shift", "outlier", "raw"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field))
    np.testing.assert_array_equal(ours.decode(True), ref.decode(True))


def test_operand_transforms_equal_reference():
    """The torch decode and truncation of every int8 byte equal the JAX
    package's, dtype included."""
    dec = TQ.msr4_decode_weights(BYTES)
    rdec = RTQ.msr4_decode_weights(jnp.asarray(BYTES.numpy()))
    assert dec.dtype == torch.int8
    np.testing.assert_array_equal(dec.numpy(), np.asarray(rdec))
    drum = TQ.drum_truncate_ops(BYTES)
    rdrum = RTQ.drum_truncate_ops(jnp.asarray(BYTES.numpy()))
    assert drum.dtype == torch.int16
    np.testing.assert_array_equal(drum.numpy(), np.asarray(rdrum))


@pytest.mark.parametrize("name,kind", FAMILY)
def test_backend_equals_gate_table_on_all_pairs(name, kind):
    got = QM.get_backend(name).fn(BYTES.reshape(256, 1), BYTES.reshape(1, 256),
                                  QuantConfig(backend=name))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), T.product_table(kind))


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 37, 9), (33, 130, 17)])
@pytest.mark.parametrize("name,kind", FAMILY)
def test_backend_int32_equals_reference_and_oracle(name, kind, shape):
    """Bitwise against the same-named JAX backend and the port's oracle."""
    m, k, n = shape
    x = RNG.integers(-128, 128, (m, k)).astype(np.int8)
    w = RNG.integers(-128, 128, (k, n)).astype(np.int8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = QM.integer_matmul(tx, tw, QuantConfig(backend=name))
    want = REFS.integer_matmul(jnp.asarray(x), jnp.asarray(w),
                               RQ.QuantConfig(backend=name))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = QM.get_backend(name).oracle or name
    np.testing.assert_array_equal(
        got.numpy(),
        QM.integer_matmul(tx, tw, QuantConfig(backend=oracle)).numpy())


@pytest.mark.parametrize("name", CORES)
def test_quantized_matmul_fuse_flag_is_noop_and_batches(name):
    """The family has no fused kernel: fuse_epilogue on or off takes the
    same path, and leading dims are the flattened rows."""
    x = torch.from_numpy(RNG.normal(size=(2, 3, 33)).astype(np.float32))
    w = torch.from_numpy((RNG.normal(size=(33, 17)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy((RNG.normal(size=(17,)) * 0.05).astype(np.float32))
    cfg = QuantConfig(backend=name)
    y = QM.quantized_matmul(x, w, cfg, bias=b, activation="relu")
    yu = QM.quantized_matmul(x, w, dataclasses.replace(
        cfg, fuse_epilogue=False), bias=b, activation="relu")
    assert torch.equal(y, yu)
    flat = QM.quantized_matmul(x.reshape(6, 33), w, cfg, bias=b,
                               activation="relu")
    assert torch.equal(y.reshape(6, 17), flat)


def test_hwproxy_equals_reference():
    assert HW.GATE == RHW.GATE
    assert HW.PAPER_TABLE3 == RHW.PAPER_TABLE3
    assert set(HW.COMPRESSORS) == set(RHW.COMPRESSORS)
    for name, nl in HW.COMPRESSORS.items():
        ref = RHW.COMPRESSORS[name]
        assert (nl.area, nl.delay, nl.energy, nl.pdp) == \
            (ref.area, ref.delay, ref.energy, ref.pdp)
        assert HW.multiplier_proxy(name) == RHW.multiplier_proxy(name)
    for kind in T.KINDS:
        assert HW.truncation_proxy(kind) == RHW.truncation_proxy(kind)
    assert HW.array_multiplier_proxy(5, 8) == RHW.array_multiplier_proxy(5, 8)
    with pytest.raises(KeyError):
        HW.truncation_proxy("nope")

"""Mesh-sharded quantized matmul (``repro_torch.quant.sharded``) in a world
of 4 gloo ranks on the CPU, a 2 x 2 ('data', 'model') mesh
(``tests/_torch_mesh_ranks.backends_rank``, a job of the session's shared
world, tests/_torch_world.py).

For every registered backend, each on its fused and (where it has one)
unfused route, under every admissible (m, n, k) axis assignment (13, K
over either axis included), the sharded float output and the sharded
int32 core equal the port's single-device ``quantized_matmul`` /
``integer_matmul`` bit for bit; so do per-tensor activation scales,
leading batch dims, RANK1 with K past its float32-exact chunk on every K
shard, and random shapes and alignments; an unknown activation is
refused; and the engine's shards of any spec (tuple entries included)
gather back to the whole tensor. Every rank returns the same outcome. No tolerance anywhere.

One direct check against the JAX package: the int32 sums of ``int8_exact``
and ``approx_deficit`` with K over 'model' and M over 'data' equal
``repro.quant.sharded.sharded_integer_matmul`` on a 2 x 2 JAX mesh
of the conftest's host devices (the JAX package's sharded
``approx_stage1`` paths take minutes on the CPU and are not called).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_ranks as R
import _torch_world as W
from repro.launch.mesh import make_serving_mesh
from repro.quant import matmul as RQM
from repro.quant import sharded as RQS
from repro.quant.quantize import abs_max_scale, for_lm, quantize

from repro_torch.quant import matmul as QM

BACKENDS = list(QM.list_backends())
RANDOM_CASES = 10


def world_args() -> tuple:
    """The arguments of ``backends_rank`` in the shared world."""
    return (RANDOM_CASES,)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.world(tmp_path_factory)["backends"]


def test_every_rank_agrees(world):
    res, ints, extra = world[0]
    for r_res, r_ints, r_extra in world[1:]:
        assert r_res == res and r_extra == extra
        assert r_ints.keys() == ints.keys()
        assert all(np.array_equal(r_ints[k], ints[k]) for k in ints)


def test_matrix_covers_registry_and_assignments(world):
    res = world[0][0]
    assert BACKENDS == list(RQM.list_backends())
    assert {b for b, _, _ in res} == set(BACKENDS)
    assert len(R.AXIS_CASES) == 13
    plans = {v[2] for v in res.values()}
    assert len(plans) == 13        # each assignment resolves to its own plan


@pytest.mark.parametrize("backend", BACKENDS)
def test_float_and_int32_parity_all_assignments(world, backend):
    res = world[0][0]
    rows = {k: v for k, v in res.items() if k[0] == backend}
    assert len(rows) == 13 * len(R._configs(backend))
    bad = [k for k, (f, i, _) in rows.items() if not (f and i)]
    assert not bad, f"diverged bitwise: {bad}"


def test_extra_cases(world):
    extra = dict(world[0][2])
    assert extra.pop("gelu_refused") is True
    assert extra.pop("gather_roundtrip") is True
    assert len([k for k in extra if k[0] == "per_tensor"]) == 7
    assert len([k for k in extra if k[0] == "batched"]) == 2
    assert len([k for k in extra if k[0] == "rank1_chunks"]) == 2
    assert len([k for k in extra if k[0] == "random"]) == RANDOM_CASES
    bad = [k for k, ok in extra.items() if ok is not True]
    assert not bad, bad


def test_int32_sums_equal_the_jax_package(world):
    ints = world[0][1]
    mesh = make_serving_mesh(shape=(2, 2))
    x, w, _ = R.operands()
    sx = abs_max_scale(jnp.asarray(x), axis=-1, keepdims=True)
    sw = abs_max_scale(jnp.asarray(w), axis=0, keepdims=True)
    x_q, w_q = quantize(jnp.asarray(x), sx), quantize(jnp.asarray(w), sw)
    np.testing.assert_array_equal(np.asarray(x_q), R.codes(x, w)[0].numpy())
    case = "m=data,n=None,k=model"          # int32 sums added across K
    for backend in ("int8_exact", "approx_deficit"):
        want = RQS.sharded_integer_matmul(x_q, w_q, for_lm(backend), mesh,
                                          **R.AXIS_CASES[case])
        np.testing.assert_array_equal(ints[(backend, case)],
                                      np.asarray(want), err_msg=backend)
    assert jax.device_count() >= 4

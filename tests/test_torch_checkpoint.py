"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's (``repro.train.checkpoint``): the same fault-tolerance contract
(round trip, a corrupt step skipped for the one before it, keep-k), the
optimizer state named and ordered as the reference's ``state_descs``, and
one on-disk format: each package restores, bit for bit, a checkpoint the
other wrote, and both write the same manifest and the same bytes for the
same tree.

The tree is that of the train loops, {"params", "opt"}, of a reduced smollm
(2 layers, d_model 64, bf16 parameters) with AdamW's quantized state (bf16
m, int8 v codes, float32 v scales, an int32 step count), its leaves filled
with seeded values of their dtypes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import transformer_lm as RT
from repro.optim import adamw as RA
from repro.train import checkpoint as RC

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer_lm as PT
from repro_torch.optim import adamw as A
from repro_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=256, vocab_pad=256, head_dim=16)


def _reference_tree():
    """{"params", "opt"} as the JAX package's train loop saves them: the
    tree of ``TLM.init`` (bf16 parameters) and of the quantized AdamW
    state, filled with seeded values of each leaf's dtype (no leaf all
    zeros or ones)."""
    rcfg = RR.reduced("smollm-135m", param_dtype=jnp.bfloat16, **SMALL)
    ocfg = RA.AdamWConfig(lr=1e-3, quantized_state=True)
    shapes = jax.eval_shape(lambda: {
        "params": RT.init(rcfg, jax.random.PRNGKey(0)),
        "opt": RA.init(RT.descs(rcfg), ocfg)})
    rng = np.random.default_rng(0)

    def fill(sds):
        dt = np.dtype(sds.dtype)
        if dt.kind == "i":
            hi = 128 if dt.itemsize == 1 else 1000
            return rng.integers(-hi + 1, hi, sds.shape).astype(dt)
        return rng.normal(size=sds.shape).astype(np.float32).astype(dt)

    return jax.tree.map(fill, shapes)


_TREE = {}


def _tree():
    if not _TREE:
        _TREE["jax"] = _reference_tree()
        _TREE["torch"] = params_from_jax(_TREE["jax"], device="cpu")
    return _TREE["jax"], _TREE["torch"]


def _equal_bits(got: torch.Tensor, want: np.ndarray, name: str):
    assert tuple(got.shape) == want.shape, name
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=name)
    else:
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_roundtrip_and_corruption_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.int32)},
            "l": [torch.full((2,), 3, dtype=torch.bfloat16)]}
    mgr.save(1, tree)
    mgr.save(2, A.unflatten((p, t * 2) for p, t in A.flatten(tree)))
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    step, restored = mgr.restore_latest(tree)
    assert step == 2
    assert isinstance(restored["l"], list)
    assert restored["l"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10) * 2)
    np.testing.assert_array_equal(restored["b"]["c"].numpy(),
                                  np.full((3, 4), 2))
    # corrupt the latest: the manager falls back to step 1
    blob = tmp_path / "step_0000000002" / "data.bin"
    raw = bytearray(blob.read_bytes())
    raw[0] ^= 0xFF
    blob.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corruption"):
        mgr.restore(2, tree)
    step, restored = mgr.restore_latest(tree)
    assert step == 1
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10))
    # a half-written step (no manifest) and a .tmp directory are not steps
    (tmp_path / "step_0000000003").mkdir()
    (tmp_path / "step_0000000004.tmp").mkdir()
    assert mgr.all_steps() == [1, 2]


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000003", "step_0000000004"]


def test_restore_refuses_a_shape_other_than_like(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"x": torch.zeros(4)})
    with pytest.raises(KeyError):
        mgr.restore(1, {"y": torch.zeros(3)})
    assert mgr.restore_latest({"x": torch.zeros(4)}) == (None, None)


def test_optimizer_state_names_and_order_follow_state_descs():
    """The port's ``adamw.init`` over the LM's parameters names, orders,
    shapes and types its leaves as the reference's ``state_descs``: the
    checkpoint's tensor list of {"params", "opt"}, name for name."""
    rcfg = RR.reduced("smollm-135m", param_dtype=jnp.bfloat16, **SMALL)
    pcfg = PR.reduced("smollm-135m", param_dtype=torch.bfloat16, **SMALL)
    for quantized in (False, True):
        rocfg = RA.AdamWConfig(quantized_state=quantized)
        want = RC._flatten(jax.eval_shape(lambda: {
            "params": RT.init(rcfg, jax.random.PRNGKey(0)),
            "opt": RA.init(RT.descs(rcfg), rocfg)}))[0]
        params = PT.init(pcfg, torch.Generator().manual_seed(0),
                         device="cpu")
        got = A.flatten({"params": params, "opt": A.init(
            params, A.AdamWConfig(quantized_state=quantized))})
        assert ["/".join(map(str, p)) for p, _ in got] == \
            [n for n, _ in want]
        for (path, t), (name, sds) in zip(got, want):
            assert tuple(t.shape) == sds.shape, name
            assert str(t.dtype).replace("torch.", "") == \
                np.dtype(sds.dtype).name, name


def test_port_restores_a_checkpoint_the_reference_wrote(tmp_path):
    want, tree = _tree()
    RC.CheckpointManager(tmp_path, async_save=False).save(7, want)
    like = A.unflatten((p, torch.zeros_like(t)) for p, t in A.flatten(tree))
    step, got = CheckpointManager(tmp_path).restore_latest(like)
    assert step == 7
    names = ["/".join(map(str, p)) for p, _ in A.flatten(got)]
    assert {"opt/count", "params/embed/table",
            "opt/params/blocks/0/k0_self/attn/wq/v_q"} <= set(names)
    for (path, t), (_, w) in zip(A.flatten(got), RC._flatten(want)[0]):
        _equal_bits(t, w, "/".join(map(str, path)))


def test_reference_restores_a_checkpoint_the_port_wrote(tmp_path):
    want, tree = _tree()
    writer = CheckpointManager(tmp_path / "port", async_save=True)
    writer.save(7, tree)
    writer.wait()
    mgr = RC.CheckpointManager(tmp_path / "port")
    step, got = mgr.restore_latest(want)
    assert step == 7
    for (name, g), (_, w) in zip(RC._flatten(got)[0],
                                 RC._flatten(want)[0]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(
            np.asarray(g).view(np.uint8), np.asarray(w).view(np.uint8),
            err_msg=name)
    # the same tree gives the same manifest and the same bytes
    RC.CheckpointManager(tmp_path / "jax", async_save=False).save(7, want)
    a, b = (tmp_path / d / "step_0000000007" for d in ("port", "jax"))
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    assert (a / "data.bin").read_bytes() == (b / "data.bin").read_bytes()

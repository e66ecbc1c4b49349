"""Training over a mesh (``train.steps.make_train_step(mesh=)``, the loop
and checkpoints over a mesh, ``parallel.pipeline``) in a world of 4 gloo
ranks on the CPU, a 2 x 2 ('data', 'model') mesh (``tests/
_torch_train_ranks.train_rank``, a job of the session's shared world,
tests/_torch_world.py). The models: the reduced smollm of
tests/test_torch_lm_train.py (2 layers, d_model 64, vocab 256) with the
JAX package's ``TLM.init`` weights at key 0, and deepseek-v2 reduced to one
layer (MLA, 8 experts top 2, a shared expert) from the port's init at seed
0; batches of 4 rows of 16 tokens.

Each rank holds:
  * three sharded steps (int8-state AdamW) under float32 products, QAT and
    the STE through approx_deficit_pallas (its plain version here) equal to
    ``make_train_step(num_microbatches=2)`` on one device bit for bit: the
    loss, and the gathered params and AdamW state after every step;
  * storage: each rank's parameter leaves have the shard shapes of the JAX
    package's pruned ``param_specs`` on a 2 x 2 mesh;
  * with two microbatches per rank, the gradient within the bound that
    ``train.steps`` states against four on one device;
  * the loop: a run that fails after step 2 and its rerun are bitwise the
    uninterrupted run; the single-device loop (two microbatches) takes the
    same losses and writes the same checkpoints (manifest: names, shapes,
    dtypes, crc32); the mesh's step-4 checkpoint restored onto a (1, 4)
    mesh gives each rank its slice, and onto one device the whole leaves;
  * ``pipeline_apply`` over the 4 ranks as a ('stage',) mesh equals the
    port's sequential loop bit for bit at 6, 1 and 3 microbatches;
  * ``make_production_mesh`` refuses a world of 4 ranks.
Against the JAX package (in the test process): the mesh's QAT step (float32
moments) matches the JAX package's ``make_train_step(num_microbatches=2)``
jitted on one CPU device, within tests/test_torch_lm_train.py's bounds
and with its rule on channel maxima; the JAX package's own sharded step
cannot run here (its ``test_sharded_loss_matches_single_device`` fails in
the embedding gather's sharding, ROADMAP queue C). The pipeline matches the
JAX package's ``pipeline_apply`` on 4 forced host devices within 1e-5, the
JAX test's bound.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding

import _torch_train_ranks as R
import _torch_world as W
import test_torch_lm_train as LT
from repro.models import transformer_lm as RT
from repro.nn import module as RM
from repro.parallel.pipeline import pipeline_apply as jax_pipeline
from repro.parallel.sharding import DEFAULT_RULES, prune_spec, use_mesh

from repro_torch.convert import params_from_jax
from repro_torch.models import transformer_lm as PT
from repro_torch.optim.adamw import flatten

SEEDS = (3, 5, 7)                 # the batches' token streams
PIPE = dict(stages=4, batch=2, width=8)
MICRO = (6, 1, 3)                 # microbatches: M > S, M = 1, M < S
PIPE_ATOL = 1e-5


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    s, b, d = PIPE["stages"], PIPE["batch"], PIPE["width"]
    ws = (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32)
    return ws, {m: rng.normal(size=(m, b, d)).astype(np.float32)
                for m in MICRO}


def _batches():
    return [dict(zip(("tokens", "labels"), LT._batch(seed=s)))
            for s in SEEDS]


def world_args(where) -> tuple:
    """The arguments of ``train_rank`` in the shared world; its
    checkpoints go under ``where``."""
    assert R.TINY == LT.TINY
    _, _, rparams = LT._tiny()
    params = params_from_jax(rparams, device="cpu")
    ws, micro = _pipeline_inputs()
    return (PT.map_leaves(lambda t: t.numpy(), params), _batches(), ws,
            micro, str(where / "ckpt"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return (W.world(tmp_path_factory)["train"], _batches(),
            W.root(tmp_path_factory) / "ckpt")


def test_every_rank_agrees(world):
    ranks = world[0]
    for r in ranks[1:]:
        for key in [k for k in r if isinstance(k, tuple)]:
            assert r[key]["losses"] == ranks[0][key]["losses"], key
        assert r["loop"]["losses"] == ranks[0]["loop"]["losses"]
        assert r["jax_step"]["loss"] == ranks[0]["jax_step"]["loss"]
    assert sorted(tuple(r["coords"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("arch", ["smollm", "moe"])
@pytest.mark.parametrize("mode", list(R.MODES))
def test_mesh_steps_bitwise_one_device(world, arch, mode):
    for r in world[0]:
        res = r[(arch, mode)]
        assert res["differ"] == [[]] * R.STEPS, res["differ"]
        assert res["losses"] == res["losses_one"]
    losses = world[0][0][(arch, mode)]["losses"]
    assert np.isfinite(losses).all() and len(set(losses)) == R.STEPS


def test_some_leaves_update_whole(world):
    """At the reduced widths a sharded last dim splits a v block (d_ff 128
    over 'model': 64 columns), so such a leaf's state is gathered and
    updated whole; a leaf stored whole (the norms' scales) updates
    alone."""
    plan = world[0][0][("smollm", "qat")]["by_shard"]
    layer = plan["blocks"][0]["k0_self"]
    assert layer["mlp"]["wg"] is False and layer["ln1"]["scale"] is True


def test_storage_shards_follow_the_reference_specs(world):
    rcfg = LT._tiny()[0]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    descs = RT.descs(rcfg)
    specs = RM.param_specs(descs, DEFAULT_RULES, mesh)
    want = jax.tree.leaves(jax.tree.map(
        lambda d, sp: NamedSharding(mesh, prune_spec(d.shape, sp, mesh))
        .shard_shape(d.shape), descs, specs, is_leaf=RM.is_desc),
        is_leaf=lambda x: isinstance(x, tuple))
    for r in world[0]:
        assert r[("smollm", "float32")]["shapes"] == want
    assert any(w != d.shape for w, d in
               zip(want, jax.tree.leaves(descs, is_leaf=RM.is_desc)))


def test_two_microbatches_per_rank_within_the_stated_bound(world):
    res = world[0][0]["bound"]
    assert res["within"], res
    assert res["worst_over_bound"] <= 1.0


def test_mesh_step_matches_the_jax_microbatched_step(world):
    """The JAX package's sharded step fails here (queue C), so the mesh's
    step is held against its single-device step with two microbatches."""
    _, _, rparams = LT._tiny()
    assert R.LR == LT.QAT_LR and world[1][0]["tokens"].tolist() == \
        LT._batch()[0].tolist()
    rp, rs, rm = LT.reference_qat_step(2)
    got = world[0][0]["jax_step"]
    LT._close(got["loss"], rm["loss"], LT.STEP_RTOL)
    pairs = zip(flatten(got["params"]), got["m"], jax.tree.leaves(rp),
                jax.tree.leaves(rs["params"])[0::2],
                jax.tree.leaves(rparams))
    for (path, p), m, want_p, want_m, w0 in pairs:
        keep = LT._not_channel_max(path, w0)
        LT._close(m, want_m, LT.STEP_RTOL, keep=keep)
        LT._close(p, want_p, LT.STEP_RTOL, absolute=True, keep=keep)


def test_loop_crash_and_resume_bitwise(world):
    for r in world[0]:
        loop = r["loop"]
        assert loop["raised"] and loop["resumed_from"] == 2
        assert loop["losses_resumed"] == loop["losses"][2:]
        assert loop["resume_differs"] == []


def _manifest(path):
    return [{k: t[k] for k in ("name", "shape", "dtype", "crc32")}
            for t in json.loads((path / "manifest.json").read_text())
            ["tensors"]]


@pytest.mark.parametrize("step", [2, 4])
def test_loop_checkpoints_equal_the_single_device_loop(world, step):
    loop = world[0][0]["loop"]
    assert loop["single_losses"] == loop["losses"]
    assert loop["single_differs"] == []
    root = world[2] / "loop"
    name = f"step_{step:010d}"
    mesh, single = _manifest(root / "whole" / name), _manifest(
        root / "single" / name)
    assert mesh == single and len(mesh) > 0
    assert (root / "whole" / name / "data.bin").read_bytes() == (
        root / "single" / name / "data.bin").read_bytes()


def test_restore_onto_another_mesh_and_one_device(world):
    for r in world[0]:
        loop = r["loop"]
        assert loop["remesh_differs"] == []
        assert loop["remesh_sharded"], "nothing was sharded on (1, 4)"
        assert loop["one_device_differs"] == []


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_matches_jax_and_the_sequential_loop(world, m):
    ws, micro = _pipeline_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("stage",))
    with use_mesh(mesh):
        want = jax_pipeline(lambda w, x: jnp.tanh(x @ w), mesh,
                            jnp.asarray(ws), jnp.asarray(micro[m]))
    outs = [r["pipeline"][m] for r in world[0]]
    for got, sequential in outs:
        assert sequential, "pipeline != the port's sequential loop"
        np.testing.assert_array_equal(got, outs[0][0])
    assert float(np.max(np.abs(outs[0][0] - np.asarray(want)))) < PIPE_ATOL


def test_production_mesh_refuses_a_world_of_four(world):
    for r in world[0]:
        assert r["production"] is not None and "has 4" in r["production"]

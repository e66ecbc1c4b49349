"""The sharded serving engine (``Engine(mesh=)``) in a world of 4 gloo ranks
on the CPU, a 2 x 2 ('data', 'model') mesh (``tests/_torch_mesh_ranks.
serve_rank``, a job of the session's shared world, tests/_torch_world.py),
on the JAX serving tests' reduced
smollm (2 layers, d_model 64, 4 heads / 2 KV heads of 16, d_ff 128, vocab
64) with the JAX package's ``TLM.init`` weights at key 0.

Each rank serves the JAX tests' scenario (2 slots, page size 4, three
prompts behind an 8-token shared prefix: the last is admitted mid-decode
into a reused slot on a prefix-cache hit) over the mesh and on one device,
and holds:
  * the sharded engine's tokens equal to the single-device engine's,
    under bf16 and the backends below;
  * the whole pool after the run, gathered from the shards, bitwise the
    single-device engine's under the quantized backends (bf16's float
    projections are not row-local: only its tokens are claimed);
  * storage sharded: MLP and vocab leaves over 'model', the pool's slot
    rows over 'data' and KV heads over 'model', the page store's pages
    over 'data';
  * 3 slots, which do not divide 'data', replicate the pool's slot dim;
  * speculation (K = 4, an approx_stage1 draft) over the mesh equal to
    sequential single-device decode.
Every rank returns the same tokens, and the tokens of the JAX tests'
workload over the mesh equal the JAX package's single-device engine's (the
port's ``*_pallas`` backends against the JAX engine's oracle)."""
import jax
import numpy as np
import pytest

import _torch_mesh_ranks as R
import _torch_refs as REFS
import _torch_world as W
from repro.quant import matmul as RQM

from repro_torch.convert import params_from_jax
from repro_torch.models import transformer_lm as PT

BACKENDS = ("bf16", "int8_exact", "approx_deficit_pallas",
            "approx_stage1_pallas", "approx_rank1_pallas")
SPEC_BACKENDS = ("bf16", "approx_deficit_pallas")
ANCHORED = ("bf16", "approx_deficit_pallas")


def _shared(vocab=64, seed=31, suffixes=(4, 3, 5), news=(2, 6, 4)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    return [(rid, np.concatenate([shared, rng.integers(0, vocab, n)
                                  .astype(np.int32)]), m)
            for rid, (n, m) in enumerate(zip(suffixes, news))]


def _odd(vocab=64):
    rng = np.random.default_rng(35)
    return [(rid, rng.integers(0, vocab, n).astype(np.int32), 3)
            for rid, n in enumerate((3, 6, 4, 5))]


def world_args() -> tuple:
    """The arguments of ``serve_rank`` in the shared world."""
    assert R.TINY == REFS.TINY and R.MAX_LEN == REFS.MAX_LEN
    rparams = REFS.init(REFS.tiny_cfg())
    params = params_from_jax(jax.tree.map(np.asarray, rparams),
                             device="cpu")
    params_np = PT.map_leaves(lambda t: t.numpy(), params)
    workloads = {"shared": _shared(), "anchor": REFS.workload(),
                 "odd": _odd()}
    return params_np, BACKENDS, workloads, SPEC_BACKENDS


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.world(tmp_path_factory)["serve"]


def _rank_free(res):
    return {k: v for k, v in res.items() if k != "storage"}


def test_every_rank_agrees(world):
    assert all(_rank_free(r) == _rank_free(world[0]) for r in world[1:])


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_tokens_equal_single_device(world, backend):
    res = world[0]
    assert res[("scenario", backend)] == (True, True), \
        "no mid-decode admission or no prefix hit"
    assert res[("equal", backend)], res[("tokens", backend)]
    if backend != "bf16":
        assert res[("pool", backend)], "the pool evolved otherwise"


def test_storage_is_sharded(world):
    full = PT.descs(R.tiny_cfg("bf16"))
    wq = full["blocks"][0]["k0_self"]["attn"]["wq"].shape
    wu = full["blocks"][0]["k0_self"]["mlp"]["wu"].shape
    for rank, res in enumerate(world):
        st = res["storage"]
        assert st["wq"] == (wq[0], wq[1], wq[2] // 2)          # heads
        assert st["wu"] == (wu[0], wu[1] // 2, wu[2] // 2)     # fsdp, mlp
        assert st["embed"] == (64 // 2, 64)                    # vocab
        assert st["k"] == (2, 1, R.MAX_LEN, 1, 16)     # slots, KV heads
        assert st["pages"][1] == 32 // 2 and st["pages"][3] == 1  # 32 pages
        assert st["pool_spec"] == (None, "data", None, "model")
        assert st["slots"] == (rank // 2, 1)           # data index


def test_odd_slots_replicate(world):
    equal, local_slots, spec = world[0]["odd"]
    assert equal and local_slots == 3
    assert spec == (None, None, None, "model")


@pytest.mark.parametrize("backend", SPEC_BACKENDS)
def test_speculation_over_the_mesh_equals_sequential(world, backend):
    assert world[0][("spec", backend)] == (True, True, True)


@pytest.mark.parametrize("backend", ANCHORED)
def test_tokens_anchored_to_the_jax_engine(world, backend):
    """The workload of tests/test_torch_serve.py's engine comparison, over
    the mesh, against the JAX package's engine (its oracle for a
    ``*_pallas`` backend)."""
    ref = backend if backend == "bf16" else RQM.get_backend(backend).oracle
    assert world[0][("anchor", backend)] == REFS.jax_served(ref)[0]

"""The port's sharding rules and plans against the JAX package's, in one
process: ``ShardingRules.spec``, ``prune_spec`` and ``shard_plan`` on a
grid and on random cases, and every registered config's parameter and
cache specs (``nn.module.param_specs`` / ``param_shardings``,
``TLM.cache_specs`` of the pool and the page store) at reduced size, leaf
for leaf. A plan reads a mesh's axis names and sizes only, so both
packages plan over layouts that no device backs (the port's
``MeshLayout``; for the JAX package an object with ``axis_names`` and a
``devices`` array of the shape), production shapes included. Also the
host-side pieces of the sharded path that need no second rank: the
one-position fallbacks, the mesh builders' factorization and their
refusals."""
import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from _hypothesis_compat import given, settings, st
from repro.configs import registry as RR
from repro.launch import mesh as RMESH
from repro.models import transformer_lm as RT
from repro.nn import module as RM
from repro.parallel import sharding as RSH
from repro.quant import sharded as RQS

from repro_torch.configs import registry as PR
from repro_torch.launch import mesh as PMESH
from repro_torch.models import transformer_lm as PT
from repro_torch.nn import module as PM
from repro_torch.parallel import sharding as PSH
from repro_torch.quant import matmul as QM
from repro_torch.quant import sharded as PQS
from repro_torch.quant.quantize import for_lm
from repro_torch.serve import Engine

AXES2 = ("data", "model")
AXES3 = ("pod", "data", "model")
LAYOUTS = [(AXES2, (1, 1)), (AXES2, (2, 2)), (AXES2, (2, 4)),
           (AXES2, (16, 16)), (AXES3, (2, 16, 16)), (("data",), (4,))]
LOGICAL = (None, "batch", "seq", "embed", "heads", "kv_heads", "head_dim",
           "mlp", "vocab", "experts", "fsdp", "layers", "kv_lora", "stage")
RULES = {"default": (RSH.DEFAULT_RULES, PSH.DEFAULT_RULES),
         "seq": (RSH.SEQ_PARALLEL_RULES, PSH.SEQ_PARALLEL_RULES),
         "wide": (RSH.WIDE_FSDP_RULES, PSH.WIDE_FSDP_RULES)}


def _meshes(names, shape):
    """(the JAX package's planning mesh, the port's)."""
    return (types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape, object)),
            PSH.MeshLayout(names, shape))


def _ps(spec):
    return tuple(spec)


def test_rules_fields_and_variants_equal():
    for key, (r, p) in RULES.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(r), key


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: str(l[1]))
def test_spec_grid(layout):
    rmesh, pmesh = _meshes(*layout)
    for key, (rr, pr) in RULES.items():
        for logical in itertools.product(LOGICAL, repeat=3):
            assert pr.spec(logical, pmesh) == _ps(rr.spec(logical, rmesh)), \
                (key, logical)


SPEC_ENTRIES = [None, "data", "model", ("data", "model"), ("model", "data"),
                "pod", ("pod", "data")]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 64), min_size=1, max_size=4),
       st.integers(0, 10 ** 6))
def test_prune_spec_random(dims, seed):
    rng = np.random.default_rng(seed)
    names, shape = LAYOUTS[int(rng.integers(len(LAYOUTS)))]
    rmesh, pmesh = _meshes(names, shape)
    entries = [e for e in SPEC_ENTRIES
               if all(a in names for a in PSH.entry_axes(e))]
    spec = tuple(entries[int(rng.integers(len(entries)))] for _ in dims)
    got = PSH.prune_spec(tuple(dims), spec, pmesh)
    assert got == _ps(RSH.prune_spec(tuple(dims), PS(*spec), rmesh))
    sizes = PSH.axis_sizes(pmesh)
    used = [a for e in got for a in PSH.entry_axes(e)]
    assert len(used) == len(set(used))          # an axis shards one dim
    for d, e in zip(dims, got):
        assert d % int(np.prod([sizes[a] for a in PSH.entry_axes(e)])) == 0


def test_prune_spec_examples():
    _, pmesh = _meshes(AXES2, (2, 4))
    assert PSH.prune_spec((8, 8), ("model", "model"), pmesh) == ("model",)
    assert PSH.prune_spec((4,), (("data", "model"),), pmesh) == ("data",)
    assert PSH.prune_spec((8,), (("data", "model"),), pmesh) == \
        (("data", "model"),)
    assert PSH.prune_spec((3, 5), ("data", "model"), pmesh) == ()


@settings(max_examples=80, deadline=None)
@given(st.integers(1, 64), st.integers(1, 200), st.integers(1, 64),
       st.integers(0, 10 ** 6))
def test_shard_plan_random(m, k, n, seed):
    rng = np.random.default_rng(seed)
    names, shape = LAYOUTS[int(rng.integers(4))]
    rmesh, pmesh = _meshes(names, shape)
    choice = (None, "data", "model", "absent")
    axes = dict(zip(("m_axis", "n_axis", "k_axis"),
                    (choice[int(rng.integers(4))] for _ in range(3))))
    assert PQS.shard_plan(m, k, n, pmesh, **axes) == \
        RQS.shard_plan(m, k, n, rmesh, **axes), (m, k, n, shape, axes)


def test_shard_plan_rules():
    _, pmesh = _meshes(AXES2, (2, 4))
    # K prime to 'model' replicates; the same axis cannot shard two dims:
    # K wins over N, M yields
    assert PQS.shard_plan(16, 4 * 7 + 1, 16, pmesh, k_axis="model",
                          n_axis="model") == ("data", "model", None)
    assert PQS.shard_plan(16, 96, 40, pmesh, m_axis="model",
                          n_axis="model", k_axis="model") == \
        (None, None, "model")
    assert PQS.shard_plan(16, 96, 40, pmesh, m_axis="nonexistent")[0] is None


def _paths(tree, prefix=()):
    """{path: leaf} of a port tree of dicts and lists (a spec tuple or a
    tensor is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def _jax_paths(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            leaf for path, leaf in flat}


@pytest.mark.parametrize("name", RR.ARCH_NAMES)
def test_param_and_cache_specs_equal(name):
    rcfg, pcfg = RR.reduced(name), PR.reduced(name)
    is_ps = lambda x: isinstance(x, PS)  # noqa: E731
    is_desc = lambda x: isinstance(x, RM.ParamDesc)  # noqa: E731
    rdescs = RT.descs(rcfg)
    rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, 8, 64, jnp.float32))
    pcache = PT.init_cache(pcfg, 8, 64, torch.float32, "meta")
    layouts = [(AXES2, (2, 2)), (AXES2, (2, 4)), (AXES2, (16, 16))]
    if PT.position_indexed(pcfg):
        rpages = jax.eval_shape(
            lambda: RT.init_page_store(rcfg, 16, 4, jnp.float32))
        ppages = PT.init_page_store(pcfg, 16, 4, torch.float32, "meta")
    for layout in layouts:
        rmesh, pmesh = _meshes(*layout)
        want = _jax_paths(RM.param_specs(rdescs, RSH.DEFAULT_RULES, rmesh),
                          is_ps)
        got = _paths(PM.param_specs(PT.descs(pcfg), PSH.DEFAULT_RULES,
                                    pmesh))
        assert got.keys() == want.keys(), name
        assert all(got[k] == _ps(want[k]) for k in want), (name, layout)
        rdesc = _jax_paths(rdescs, is_desc)
        stored = _paths(PM.param_shardings(PT.descs(pcfg),
                                           PSH.DEFAULT_RULES, pmesh))
        for k, spec in want.items():
            assert stored[k] == _ps(RSH.prune_spec(rdesc[k].shape, spec,
                                                   rmesh)), (name, k)
        trees = [(rcache, pcache)]
        if PT.position_indexed(pcfg):
            trees.append((rpages, ppages))
        for rtree, ptree in trees:
            want = _jax_paths(RT.cache_specs(rcfg, rtree, RSH.DEFAULT_RULES,
                                             rmesh), is_ps)
            got = _paths(PT.cache_specs(pcfg, ptree, PSH.DEFAULT_RULES,
                                        pmesh))
            assert got.keys() == want.keys(), name
            assert all(got[k] == _ps(want[k]) for k in want), (name, layout)


def test_cache_logical_equal():
    for name in RR.ARCH_NAMES:
        want = _jax_paths(RT.cache_logical(RR.reduced(name)),
                          lambda x: isinstance(x, tuple))
        got = _paths(PT.cache_logical(PR.reduced(name)))
        assert got == want, name


# ---------------------------------------------------------------------------
# One position, the builders, the refusals
# ---------------------------------------------------------------------------

def test_one_position_falls_back():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    cfg = for_lm("approx_deficit")
    ref = QM.quantized_matmul(x, w, cfg, b)
    for mesh in (None, PMESH.make_host_mesh()):
        assert torch.equal(PQS.sharded_quantized_matmul(x, w, cfg, mesh, b),
                           ref)
    f = PQS.make_sharded_matmul(cfg, PMESH.make_host_mesh())
    assert torch.equal(f(x, w, bias=b), ref)


def test_serving_shape_and_host_mesh():
    for n in range(1, len(jax.devices()) + 1):
        want = RMESH.make_serving_mesh(devices=jax.devices()[:n])
        assert PMESH.serving_shape(n) == want.devices.shape
    host = PMESH.make_host_mesh()
    assert host.mesh_dim_names == AXES2 and tuple(host.shape) == (1, 1)
    assert PSH.mesh_positions(host) == 1
    mesh = PSH.MeshLayout(AXES2, (2, 4))
    assert PSH.mesh_axis_size("model", mesh) == 4
    assert PSH.mesh_axis_size("pod", mesh) == 1
    assert PSH.mesh_axis_size("model", None) == 1
    x = torch.zeros(3)
    assert PSH.constrain(x, PSH.DEFAULT_RULES, "batch") is x


def test_refusals_without_a_process_group(monkeypatch):
    for key in PMESH.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        PMESH.init_distributed("gloo", "cpu")
    with pytest.raises(ValueError, match="nccl or gloo"):
        PMESH.init_distributed("mpi", "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        PMESH.make_serving_mesh()
    from repro_torch.serve import __main__ as CLI
    with pytest.raises(SystemExit, match="no process group"):
        CLI.main(["--reduced", "--device", "cpu", "--mesh", "data,model",
                  "--dist-backend", "gloo"])
    with pytest.raises(SystemExit, match="--dist-backend"):
        CLI.main(["--reduced", "--device", "cpu", "--mesh", "data,model"])


def test_engine_on_one_position_serves_unsharded():
    cfg = PR.reduced("smollm-135m", n_layers=1, d_model=32, n_heads=2,
                     n_kv_heads=2, d_ff=64, vocab=64, vocab_pad=64,
                     head_dim=16)
    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, slots=2, max_len=16, device="cpu",
                 mesh=PMESH.make_host_mesh())
    assert eng.mesh is None and eng.plan is None and eng.params is params

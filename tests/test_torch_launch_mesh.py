"""The port's launch tooling over a mesh (``launch.specs`` with ``mesh=``,
``launch.dryrun.state_bytes_per_rank``, ``launch.mesh.production_layout``)
against the JAX package's ``repro.launch``, on the CPU. Only abstract trees
are built: meta tensors on the port's side, ``ShapeDtypeStruct`` with
``NamedSharding`` on the JAX side.

* **Specs.** For every arch at each of its applicable shapes, the spec of
  every parameter, optimizer-state (int8 moments), cache and input leaf
  equals the JAX package's ``NamedSharding`` spec on a (2, 4) ('data',
  'model') mesh of the forced host devices, leaf for leaf; the cache
  leaves by the JAX dry-run's own ``spec_for`` (TP over the KV heads or
  else head_dim, the sequence over 'data' for ``long_500k`` at batch 1).
* **Bytes per rank.** ``state_bytes_per_rank`` equals the sum of the JAX
  shardings' ``shard_shape`` bytes over the same trees (the gradients
  sharded as the parameters).
* **Production meshes.** ``production_layout`` has the shapes and axis
  names that the JAX package's ``make_production_mesh`` asks
  ``jax.make_mesh`` for (256 and 512 devices, which this host does not
  have; the function is called with ``jax.make_mesh`` recording its
  arguments).
"""
import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import registry as RR
from repro.launch import mesh as RMESH
from repro.launch import specs as RSP
from repro.optim import adamw as RA

from repro_torch.configs import registry
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as SP
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import MeshLayout

CELLS = [(a, s) for a in registry.ARCH_NAMES
         for s in registry.applicable_shapes(a)]
SHAPE = (2, 4)
LAYOUT = MeshLayout(("data", "model"), SHAPE)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(SHAPE),
                ("data", "model"))


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


def _jax(tree):
    """[(path, spec, shard bytes)] of a tree of ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(_key(k) for k in path), tuple(leaf.sharding.spec),
             int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
             * np.dtype(leaf.dtype).itemsize) for path, leaf in flat]


def _port(tree, specs, path=()):
    """[(path, spec)] in the JAX package's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port(tree[k], specs[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _port(t, specs[i], path + (i,))]
    return [(path, specs)]


def _specs_equal(got, want):
    assert [p for p, _ in got] == [p for p, _, _ in want]
    bad = [(p, g, w) for (p, g), (_, w, _) in zip(got, want) if g != w]
    assert not bad, bad[:5]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_mesh_specs_match_reference(arch, shape):
    cfg, rcfg, mesh = registry.get(arch), RR.get(arch), _mesh()
    ocfg = adamw.AdamWConfig(quantized_state=True)
    params, opt, pspec, ospec = SP.model_state_specs(cfg, ocfg, LAYOUT)
    rparams, ropt = RSP.model_state_specs(
        rcfg, mesh, opt_cfg=RA.AdamWConfig(quantized_state=True))
    cache, cspec = SP.cache_specs(cfg, shape, mesh=LAYOUT)
    inputs, ispec = SP.input_specs(cfg, shape, LAYOUT)
    want = {"params": _jax(rparams), "opt": _jax(ropt),
            "cache": _jax(RSP.cache_specs(rcfg, shape, mesh)),
            "inputs": _jax(RSP.input_specs(rcfg, shape, mesh))}
    got = {"params": _port(params, pspec), "opt": _port(opt, ospec),
           "cache": _port(cache, cspec), "inputs": _port(inputs, ispec)}
    for name in got:
        _specs_equal(got[name], want[name])
    per_rank = DR.state_bytes_per_rank(cfg, shape, LAYOUT)
    kind = registry.SHAPES[shape][2]
    total = sum(b for part in want.values() for _, _, b in part)
    if kind == "train":
        total += sum(b for _, _, b in want["params"])      # the gradients
        total -= sum(b for _, _, b in want["cache"])       # no cache
    else:
        total -= sum(b for _, _, b in want["opt"])         # no optimizer
    assert per_rank["total"] == total
    assert per_rank["params"] == sum(b for _, _, b in want["params"])
    assert per_rank["fits"] == (total <= PM.DEVICE_MEMORY_BYTES)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_layout_is_the_reference_mesh(monkeypatch, multi_pod):
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (shape, axes))
    shape, axes = RMESH.make_production_mesh(multi_pod=multi_pod)
    layout = PM.production_layout(multi_pod)
    assert tuple(layout.shape) == tuple(shape)
    assert tuple(layout.mesh_dim_names) == tuple(axes)


def test_dryrun_mesh_records_sit_beside_the_single_card_ones(tmp_path):
    """``--mesh`` tags its records: the single-card record of the same cell
    is not overwritten, and the per-rank state is the layout's."""
    assert DR.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                    "--out", str(tmp_path)]) == 0
    assert DR.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                    "--mesh", "16x16", "--out", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["smollm-135m_decode_32k.json",
                     "smollm-135m_decode_32k_mesh16x16.json"]
    rec = json.loads((tmp_path / names[1]).read_text())
    assert rec["mesh"] == {"name": "16x16", "axes": ["data", "model"],
                           "shape": [16, 16]}
    assert rec["state_bytes_per_rank"] == DR.state_bytes_per_rank(
        registry.get("smollm-135m"), "decode_32k", PM.production_layout())
    assert "state_bytes_per_rank" not in json.loads(
        (tmp_path / names[0]).read_text())

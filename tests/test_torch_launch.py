"""The port's launch tooling (``repro_torch.launch``) against the JAX
package's ``repro.launch``, on the CPU.

* **Specs.** For every arch and each of its applicable shapes, the port's
  parameter, optimizer-state (int8 moments) and cache trees, and the
  cell's inputs, equal the JAX package's ``ShapeDtypeStruct`` trees (built
  on ``make_host_mesh()``) leaf for leaf, in path, shape and dtype, and
  their byte totals are equal. The port's are meta tensors: kimi-k2's
  trillion parameters allocate nothing.
* **FLOPs.** ``dryrun.step_cost`` of a reduced train step and decode step
  (smollm: dense; deepseek-v2: MLA and mixture of experts; rwkv6: the
  chunked WKV) against the dot FLOPs that the JAX package's ``HloCost``
  counts in the same step compiled on the CPU. Tolerance 1 % each.
  Measured: smollm and deepseek-v2 agree exactly (the port's experts
  counted at their capacity, as the JAX graph computes them); rwkv6's
  decode exactly, its train step 0.49 % below the JAX count: the port's
  forward counts 524,288 more (the first chunk's inter-chunk product
  ``rp @ S`` of ``wkv_chunked``, against the zero initial state, which XLA
  folds away) and its backward 1,015,808 fewer (XLA's transposes of the
  chunk einsums).
* **The dry-run itself.** Extrapolating over the block program's repeats
  and the microbatches equals tracing every layer and microbatch; a
  quantized backend's int8 products are 2 x rows x K x N of the
  projection list; the bytes of a decode step are the ones the cache
  layout gives; a mixture-of-experts step's bound counts only the experts
  and rows its tokens are routed to; the CLI writes one record per cell.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as RR
from repro.launch import specs as RSP
from repro.launch.hlo_costs import HloCost
from repro.launch.mesh import make_host_mesh
from repro.models import transformer_lm as RT
from repro.nn import module as RM
from repro.optim import adamw as RA
from repro.train import steps as RS

from repro_torch.configs import registry
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as SP
from repro_torch.optim import adamw
from repro_torch.quant.quantize import for_lm

CELLS = [(a, s) for a in registry.ARCH_NAMES
         for s in registry.applicable_shapes(a)]
FLOP_ARCHS = ("smollm-135m", "deepseek-v2-236b", "rwkv6-3b")
FLOP_RTOL = {"smollm-135m": 1e-2, "deepseek-v2-236b": 1e-2,
             "rwkv6-3b": 1e-2}
TRAIN_SHAPE = (2, 16)          # batch, tokens
DECODE_SHAPE = (2, 32)         # batch, cache positions (decode at the last)


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


def _jax_leaves(tree):
    """[(path, shape, dtype name)] in the JAX package's leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(_key(k) for k in path), tuple(leaf.shape),
             str(leaf.dtype)) for path, leaf in flat]


def _port_leaves(tree):
    out = []
    for path, t in adamw.flatten(tree):
        assert t.is_meta, f"{path} is allocated on {t.device}"
        out.append((tuple(path), tuple(t.shape),
                    str(t.dtype).replace("torch.", "")))
    return out


def _nbytes(leaves):
    return sum(int(np.prod(shape)) * np.dtype(
        jnp.dtype(dtype)).itemsize for _, shape, dtype in leaves)


@functools.lru_cache(maxsize=None)
def _reference_state(arch: str):
    mesh = make_host_mesh()
    params, opt = RSP.model_state_specs(
        RR.get(arch), mesh, opt_cfg=RA.AdamWConfig(quantized_state=True))
    return _jax_leaves(params), _jax_leaves(opt)


def test_registry_shapes_match_reference():
    assert registry.SHAPES == RR.SHAPES
    for arch in registry.ARCH_NAMES:
        assert registry.applicable_shapes(arch) == RR.applicable_shapes(arch)
    assert len(CELLS) == 34


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_reference(arch, shape):
    """Params and int8-moment optimizer state per arch, caches and inputs
    per cell: the same leaves, shapes and dtypes, the same bytes."""
    cfg, rcfg, mesh = registry.get(arch), RR.get(arch), make_host_mesh()
    rparams, ropt = _reference_state(arch)
    params, opt = SP.model_state_specs(
        cfg, adamw.AdamWConfig(quantized_state=True))
    got = {"params": _port_leaves(params), "opt": _port_leaves(opt),
           "cache": _port_leaves(SP.cache_specs(cfg, shape)),
           "inputs": _port_leaves(SP.input_specs(cfg, shape))}
    want = {"params": rparams, "opt": ropt,
            "cache": _jax_leaves(RSP.cache_specs(rcfg, shape, mesh)),
            "inputs": _jax_leaves(RSP.input_specs(rcfg, shape, mesh))}
    for name in got:
        assert got[name] == want[name], name
        assert _nbytes(got[name]) == _nbytes(want[name])
    assert SP.nbytes(params) == _nbytes(rparams)
    assert SP.nbytes(SP.cache_specs(cfg, shape)) == _nbytes(want["cache"])


def test_kimi_state_stays_abstract():
    params, opt = SP.model_state_specs(
        registry.get("kimi-k2-1t-a32b"),
        adamw.AdamWConfig(quantized_state=True))
    leaves = [t for _, t in adamw.flatten(params) + adamw.flatten(opt)]
    assert all(t.is_meta for t in leaves)
    assert SP.nbytes(params) > 1e12           # 1 T bf16 parameters


def _sds(desc_tree):
    return jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype),
                        desc_tree, is_leaf=RM.is_desc)


@pytest.fixture(scope="module")
def jax_dot_flops():
    """The dot FLOPs of the JAX package's reduced train and decode steps,
    compiled on the CPU from abstract arguments (each compiled once; the
    train step with AdamW's float moments, whose update holds no dot)."""
    @functools.lru_cache(maxsize=None)
    def flops(arch: str, kind: str) -> float:
        cfg = RR.reduced(arch)
        d = RT.descs(cfg)
        if kind == "train":
            b, s = TRAIN_SHAPE
            # float moments: the same dots, a smaller program to compile
            ocfg = RA.AdamWConfig()
            batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
            lowered = jax.jit(RS.make_train_step(cfg, ocfg)).lower(
                _sds(d), _sds(RA.state_descs(d, ocfg)), batch)
        else:
            b, n = DECODE_SHAPE
            cache = jax.eval_shape(
                lambda: RT.init_cache(cfg, b, n, jnp.bfloat16))
            lowered = jax.jit(RS.make_serve_step(cfg)).lower(
                _sds(d), cache, jax.ShapeDtypeStruct((b, 1), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
        hc = HloCost(lowered.compile().as_text())
        return hc.flops + hc.flops_int8
    return flops


@pytest.mark.parametrize("kind", ("train", "decode"))
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_step_flops_match_reference(jax_dot_flops, arch, kind):
    cfg = registry.reduced(arch)
    b, s = TRAIN_SHAPE if kind == "train" else DECODE_SHAPE
    got = DR.step_cost(cfg, kind, b, s)
    want = jax_dot_flops(arch, kind)
    assert got["flops"] == pytest.approx(want, rel=FLOP_RTOL[arch]), \
        (got["flops"], want)
    assert got["flops_int8"] == 0 and got["int8_products"] == 0


@pytest.mark.parametrize("arch,kind", [
    ("smollm-135m", "train"), ("smollm-135m", "decode"),
    ("gemma3-27b", "decode"), ("gemma3-27b", "prefill"),
    ("deepseek-v2-236b", "train"), ("hymba-1.5b", "decode")])
def test_extrapolation_equals_every_layer(arch, kind):
    """Counting none / one repeat (train: one / two) and one microbatch,
    then extrapolating, equals tracing the whole step: three repeats of
    the block program's group (gemma3: of its 5:1 group, beside the
    remainder group of two global layers), two microbatches."""
    base = registry.reduced(arch)
    per = len(base.blocks()[0][1])
    rem = 2 if arch == "gemma3-27b" else 0
    cfg = dataclasses.replace(base, n_layers=3 * per + rem,
                              quant=for_lm("approx_deficit_pallas"))
    mb = 2 if kind == "train" else 1
    fast = DR.step_cost(cfg, kind, 4, 8, microbatches=mb)
    slow = DR.step_cost(cfg, kind, 4, 8, microbatches=mb, exact=True)
    assert len(fast["depths_traced"]) == 2
    assert slow["depths_traced"] == [cfg.n_layers]
    for key in ("flops", "flops_min", "flops_int8", "int8_products",
                "bytes_min"):
        assert fast[key] == slow[key], key


@pytest.mark.parametrize("arch", ("smollm-135m", "qwen1.5-32b",
                                  "deepseek-coder-33b", "gemma3-27b",
                                  "deepseek-v2-236b", "kimi-k2-1t-a32b",
                                  "rwkv6-3b", "hymba-1.5b",
                                  "llama-3.2-vision-11b", "musicgen-large"))
def test_int8_products_follow_the_projection_list(arch):
    """Under a quantized backend the same products run, and those of the
    projections (``projection_shapes``, the list ``chip_smoke.py``'s
    launch counts and kernel bounds read) run on int8 codes; a cross
    layer's k and v take the encoder states' rows."""
    cfg = registry.reduced(arch)
    rows = 3
    flt = DR.step_cost(cfg, "decode", rows, 16)
    q = DR.step_cost(dataclasses.replace(
        cfg, quant=for_lm("approx_deficit_pallas")), "decode", rows, 16)
    assert q["flops"] == flt["flops"]
    shapes = DR.projection_shapes(cfg)
    want = 2 * rows * sum(k * n for k, n in shapes)
    if cfg.cross_every:
        n_cross = sum(rep * kinds.count("cross")
                      for rep, kinds in cfg.blocks())
        kvd = cfg.n_kv_heads * cfg.dh
        want += 2 * n_cross * 2 * rows * (cfg.enc_len - 1) * cfg.d_model * kvd
    assert q["flops_int8"] == want
    assert q["int8_products"] == len(shapes)


def test_decode_bytes_follow_the_cache_layout():
    """smollm reduced (2 layers, one KV head of 32): each cache position
    holds k and v, 2 x 32 bf16 values a layer; rows at positions 3 and 5
    read 4 and 6 positions, and write one each."""
    cfg = registry.reduced("smollm-135m")
    assert (cfg.n_layers, cfg.n_kv_heads, cfg.dh) == (2, 1, 32)
    per_pos = 2 * 2 * 32 * 2
    got = DR.step_cost(cfg, "decode", 2, 8, pos=[3, 5])
    io = got["bytes"]
    assert io["cache_read"] == per_pos * (4 + 6)
    assert io["cache_written"] == 2 * per_pos
    assert io["inputs"] == 2 * 4 and io["outputs"] == 2 * 4
    assert io["params"] == SP.nbytes(SP.model_state_specs(cfg))
    assert got["bytes_min"] == sum(io.values())
    assert got["bound_ms"] == pytest.approx(PM.bound_ms(
        got["flops"], 0, got["bytes_min"]))
    assert got["bound_by"] == "bytes"


@pytest.mark.parametrize("kind,remat", [("decode", False),
                                        ("prefill", False),
                                        ("train", False), ("train", True)])
def test_bound_counts_only_routed_experts(kind, remat):
    """deepseek-v2 reduced (8 experts, top 2, capacity factor 1.25): a
    decode step of 2 rows routes 4 (token, expert) pairs a layer, so its
    bound reads 4 of the 8 experts' weights and multiplies 4 rows, where
    the JAX graph multiplies every expert at its capacity of 1 (16 rows);
    a prefill of 2 x 3 tokens keeps 6 pairs a group (capacity 1), which
    reach all 8 experts; a train step reads every parameter, and its
    padding costs the forward, the backward's two products and, under
    remat, the forward's recomputation."""
    cfg = dataclasses.replace(registry.reduced("deepseek-v2-236b"),
                              remat=remat)
    mc = cfg.moe_cfg()
    assert (mc.n_experts, mc.top_k, mc.capacity_factor) == (8, 2, 1.25)
    b, s = 2, 3
    got = DR.step_cost(cfg, kind, b, s, exact=True)
    params = SP.meta_tree(DR.TLM.descs(cfg))
    experts = sum(SP.nbytes(lp["moe"][w]) for blk in params["blocks"]
                  for lp in blk.values() for w in ("w1", "w2", "w3"))
    per_row = 2 * 3 * cfg.n_layers * mc.d_model * mc.d_ff
    if kind == "decode":
        assert got["bytes"]["params"] == SP.nbytes(params) - experts // 2
        assert got["flops"] - got["flops_min"] == per_row * b * (8 - 2)
    elif kind == "prefill":
        assert got["bytes"]["params"] == SP.nbytes(params)
        assert got["flops"] - got["flops_min"] == per_row * b * (8 - 6)
    else:
        assert got["bytes"]["params"] == SP.nbytes(params)
        assert got["flops"] - got["flops_min"] == \
            (3 + remat) * per_row * b * (8 - 6)
    assert got["bound_ms"] == pytest.approx(PM.bound_ms(
        got["flops_min"], 0, got["bytes_min"]))


def test_bound_takes_the_slower_of_products_and_bytes():
    assert PM.bound_ms(989e12, 0, 0) == pytest.approx(1e3)
    assert PM.bound_ms(2 * 1979e12, 1979e12, 0) == pytest.approx(
        1e3 * (1979e12 / 989e12 + 1))
    assert PM.bound_ms(0, 0, 3.35e12) == pytest.approx(1e3)


def test_dryrun_cli_writes_one_record_per_cell(tmp_path, capsys):
    assert DR.cells(None, None, True) == CELLS
    assert DR.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                    "--out", str(tmp_path)]) == 0
    rec = __import__("json").loads(
        (tmp_path / "smollm-135m_decode_32k.json").read_text())
    assert rec["arch"] == "smollm-135m" and rec["kind"] == "decode"
    assert rec["flops"] > 0 and rec["bytes_min"] > 0
    assert rec["fits_one_card"] is False        # a 90 GiB cache
    assert rec["state_bytes"]["caches"] == SP.nbytes(
        SP.cache_specs(registry.get("smollm-135m"), "decode_32k"))
    assert "1 of 1 cells counted" in capsys.readouterr().out

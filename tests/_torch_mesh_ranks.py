"""Rank functions of the port's sharded tests: each runs in every rank of a
spawned world (``repro_torch.parallel.collectives.run_world``) and returns
host objects to the test. This module imports no JAX, so that a spawned
rank does not import it."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import factor as F
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer_lm as TLM
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import abs_max_scale, for_lm, quantize
from repro_torch.quant.sharded import (shard_plan, sharded_integer_matmul,
                                       sharded_quantized_matmul)
from repro_torch.serve import Engine, ServeRequest, SpecConfig
from repro_torch.serve.engine import gather_leaves, slice_leaf

# every admissible (m, n, k) axis assignment over a ('data', 'model')
# mesh: each dim replicated or over one axis, no axis on two dims (13)
def _cases():
    out = {}
    for m in (None, "data", "model"):
        for n in (None, "data", "model"):
            for k in (None, "data", "model"):
                used = [a for a in (m, n, k) if a]
                if len(used) == len(set(used)):
                    out[f"m={m},n={n},k={k}"] = dict(m_axis=m, n_axis=n,
                                                     k_axis=k)
    return out


AXIS_CASES = _cases()
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64, vocab_pad=64, head_dim=16)
MAX_LEN = 32


def operands(m=16, k=96, n=40, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


def codes(x, w):
    """Per-token activation and per-channel weight codes (numpy in)."""
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    sx = abs_max_scale(x, axis=-1, keepdims=True)
    sw = abs_max_scale(w, axis=0, keepdims=True)
    return quantize(x, sx).contiguous(), quantize(w, sw).contiguous()


def _configs(backend):
    cfg = for_lm(backend)
    out = {"fused": cfg}
    if QM.get_backend(backend).fused is not None:
        out["unfused"] = dataclasses.replace(cfg, fuse_epilogue=False)
    return out


def backends_rank(rank: int, randoms: int):
    """Every backend's sharded float output and int32 core against the
    single-device call, under every axis case, and the extra cases; the
    outcome per (backend, route, case), and the int32 sums the test holds
    against the JAX package's."""
    torch.set_num_threads(1)
    mesh = make_serving_mesh((2, 2), device_type="cpu")
    x, w, b = (torch.from_numpy(a) for a in operands())
    x_q, w_q = codes(*operands()[:2])
    res = {}
    ints = {}
    for backend in QM.list_backends():
        for route, cfg in _configs(backend).items():
            ref = QM.quantized_matmul(x, w, cfg, b, "relu")
            ref_int = QM.integer_matmul(x_q, w_q, cfg)
            for case, axes in AXIS_CASES.items():
                out = sharded_quantized_matmul(x, w, cfg, mesh, b, "relu",
                                               **axes)
                acc = sharded_integer_matmul(x_q, w_q, cfg, mesh, **axes)
                res[(backend, route, case)] = (
                    torch.equal(out, ref), torch.equal(acc, ref_int),
                    shard_plan(16, 96, 40, mesh, **axes))
                if backend in ("int8_exact", "approx_deficit") and \
                        route == "fused":
                    ints[(backend, case)] = acc.numpy()
    extra = {}
    # per-tensor activation scales (the training configs)
    xp, wp, bp = (torch.from_numpy(a) for a in operands(seed=7))
    for backend in ("int8_exact", "approx_deficit", "approx_rank1",
                    "approx_deficit_pallas", "approx_rank1_pallas"):
        for route, cfg in _configs(backend).items():
            cfg = dataclasses.replace(cfg, act_scale="per_tensor")
            ref = QM.quantized_matmul(xp, wp, cfg, bp, None)
            extra[("per_tensor", backend, route)] = all(
                torch.equal(sharded_quantized_matmul(
                    xp, wp, cfg, mesh, bp, None, **axes), ref)
                for axes in AXIS_CASES.values())
    # leading batch dims flatten to rows as quantized_matmul's do
    xb, wb, _ = (torch.from_numpy(a) for a in operands(8, 96, 40, seed=5,
                                                        lead=(4,)))
    for backend in ("approx_deficit", "approx_stage1_pallas"):
        cfg = for_lm(backend)
        ref = QM.quantized_matmul(xb, wb, cfg)
        out = sharded_quantized_matmul(xb, wb, cfg, mesh)
        extra[("batched", backend)] = (out.shape == (4, 8, 40)
                                       and torch.equal(out, ref))
    # RANK1 with K past its float32-exact chunk on every K shard
    kc = F.factorize("proposed").k_exact_f32
    k = 2 * (kc + 17)
    rng = np.random.default_rng(11)
    xq = torch.from_numpy(rng.integers(-127, 128, (4, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, 8)).astype(np.int8))
    for backend in ("approx_rank1", "approx_rank1_pallas"):
        cfg = for_lm(backend)
        out = sharded_integer_matmul(xq, wq, cfg, mesh, n_axis=None,
                                     k_axis="model")
        extra[("rank1_chunks", backend)] = (
            torch.equal(out, QM.integer_matmul(xq, wq, cfg))
            and torch.equal(out, QM.integer_matmul(xq, wq,
                                                   for_lm("approx_lut"))))
    # random shapes, alignments and axis cases
    rng = np.random.default_rng(1234 + randoms)
    cases = list(AXIS_CASES.values())
    for i in range(randoms):
        m, k, n = (int(rng.integers(1, 33)), int(rng.integers(1, 129)),
                   int(rng.integers(1, 65)))
        backend = ("int8_exact", "approx_deficit", "approx_stage1_fused",
                   "approx_rank1", "approx_deficit_pallas")[i % 5]
        axes = cases[int(rng.integers(len(cases)))]
        xr = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        wr = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
        cfg = for_lm(backend)
        extra[("random", i, (m, k, n), backend, str(axes))] = torch.equal(
            sharded_quantized_matmul(xr, wr, cfg, mesh, **axes),
            QM.quantized_matmul(xr, wr, cfg))
    # shards of any spec, tuple entries included, gather back whole
    specs = [(("data", "model"),), (None, ("model", "data")),
             ("model", "data"), ("data", None, "model"), ()]
    full = [torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6),
            torch.arange(4 * 8, dtype=torch.int16).reshape(4, 8),
            torch.arange(4 * 6, dtype=torch.bfloat16).reshape(4, 6),
            torch.arange(2 * 3 * 4).reshape(2, 3, 4), torch.ones(5)]
    shards = [slice_leaf(t, sp, mesh) for t, sp in zip(full, specs)]
    back = gather_leaves(shards, specs, mesh)
    extra["gather_roundtrip"] = all(
        torch.equal(b, t) and b.dtype == t.dtype for b, t in zip(back, full))
    try:
        sharded_quantized_matmul(x, w, for_lm("int8_exact"), mesh,
                                 activation="gelu")
        extra["gelu_refused"] = False
    except ValueError:
        extra["gelu_refused"] = True
    return res, ints, extra


# ---------------------------------------------------------------------------
# The sharded engine
# ---------------------------------------------------------------------------

def tiny_cfg(backend):
    return dataclasses.replace(registry.reduced("smollm-135m", **TINY),
                               quant=for_lm(backend))


def _run(cfg, params, workload, *, slots, mesh=None, spec=None, **kw):
    eng = Engine(cfg, params, slots=slots, max_len=MAX_LEN, mesh=mesh,
                 spec=spec, device="cpu", **kw)
    for rid, prompt, max_new in workload:
        eng.submit(ServeRequest(rid=rid, prompt=prompt, max_new=max_new))
    stats = eng.run()
    return {r.rid: list(r.output) for r in eng.completed}, stats, eng


def _pool_equal(a, b):
    out = []
    TLM.map_leaves(lambda x, y: out.append(torch.equal(x, y)), a, b)
    return all(out)


def serve_rank(rank: int, params_np, backends, workloads, spec_backends):
    """The sharded engine against the single-device engine on the same
    rank, per backend: tokens, the whole pool after the run (bitwise for
    the quantized backends), storage shapes, odd slots, a one-position
    mesh, and speculation over the mesh against sequential single-device
    decode."""
    torch.set_num_threads(1)
    mesh = make_serving_mesh((2, 2), device_type="cpu")
    params = TLM.map_leaves(torch.from_numpy, params_np)
    shared = workloads["shared"]
    res = {}
    for backend in backends:
        cfg = tiny_cfg(backend)
        ref, _, ref_eng = _run(cfg, params, shared, slots=2, page_size=4)
        out, stats, eng = _run(cfg, params, shared, slots=2, page_size=4,
                               mesh=mesh)
        res[("tokens", backend)] = out
        res[("equal", backend)] = out == ref
        res[("scenario", backend)] = (stats["waves"] >= 2,
                                      eng.prefix_hit_tokens >= 8)
        res[("pool", backend)] = _pool_equal(eng.plan.full_pool(eng.pool),
                                             ref_eng.pool)
        if backend == backends[0]:
            res["storage"] = {
                "wq": tuple(eng.params["blocks"][0]["k0_self"]["attn"]["wq"]
                            .shape),
                "wu": tuple(eng.params["blocks"][0]["k0_self"]["mlp"]["wu"]
                            .shape),
                "embed": tuple(eng.params["embed"]["table"].shape),
                "k": tuple(eng.pool["blocks"][0]["k0_self"]["k"].shape),
                "pages": tuple(eng.pages["blocks"][0]["k0_self"]["k"].shape),
                "slots": (eng.plan.slot0, eng.plan.local_slots),
                "pool_spec": eng.plan.pool_specs["blocks"][0]["k0_self"]
                ["k"]}
    # the anchor workload (the JAX engine's, in the test)
    for backend in ("bf16", "approx_deficit_pallas"):
        res[("anchor", backend)] = _run(tiny_cfg(backend), params,
                                        workloads["anchor"], slots=2,
                                        page_size=4, mesh=mesh)[0]
    # slots that do not divide 'data' replicate the pool
    cfg = tiny_cfg("approx_deficit")
    ref = _run(cfg, params, workloads["odd"], slots=3)[0]
    out, _, eng = _run(cfg, params, workloads["odd"], slots=3, mesh=mesh)
    res["odd"] = (out == ref, eng.plan.local_slots,
                  eng.plan.pool_specs["blocks"][0]["k0_self"]["k"])
    # speculation over the mesh == sequential single-device decode
    for backend in spec_backends:
        cfg = tiny_cfg(backend)
        ref = _run(cfg, params, shared, slots=2, page_size=4)[0]
        out, stats, eng = _run(
            cfg, params, shared, slots=2, page_size=4, mesh=mesh,
            spec=SpecConfig(k=4, draft_backend="approx_stage1"))
        res[("spec", backend)] = (out == ref, stats["spec_passes"] > 0,
                                  eng.prefix_hit_tokens >= 8)
    return res


def world_rank(rank: int, jobs: dict) -> dict:
    """Every job of the session's shared test world (tests/_torch_world.py)
    on this rank, in turn: {name: (module, function, args)} -> {name:
    function(rank, *args)}."""
    import importlib
    return {name: getattr(importlib.import_module(module), fn)(rank, *args)
            for name, (module, fn, args) in jobs.items()}

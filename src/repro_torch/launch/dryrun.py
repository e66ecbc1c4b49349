"""Dry-run of the port's LM steps: FLOPs, bytes and state per cell, on the
``meta`` device, after the JAX package's ``repro.launch.dryrun``.

For each (arch x applicable shape) cell it builds the port's own step at
the arch's published widths on the meta device (parameters, optimizer
state, caches and inputs from ``launch.specs``; nothing is allocated and
no weight is drawn) and runs it once under
``torch.utils.flop_counter.FlopCounterMode``:

  train    ``train.steps.make_train_step`` (int8-state AdamW), with the
           JAX dry-run's default of 8 microbatches for d_model >= 4096;
  prefill  ``TLM.prefill`` of the whole prompt into a fresh cache;
  decode   ``train.steps.make_serve_step``: one token per row at the
           cache's last position.

Each record (``experiments/torch/dryrun/<tag>.json``) holds ``flops`` (every
product the step runs as the JAX graph computes it: 2 x MACs, the experts
at their capacity), ``flops_min`` (the same without the capacity's
padding: the experts at the routed rows), ``flops_int8`` (the products
that ``--quant B`` runs on int8 codes, on the card the kernels K1-K4),
``bytes_min`` (each input read once and each output written once: the
parameters at their dtype, of a mixture-of-experts layer in prefill or
decode only the experts its rows can reach, the cache positions a decode
step reads, the inputs, the cache positions written, the outputs; a train
step's outputs are the new parameters and optimizer state), the state
bytes of parameters, gradients, optimizer state, caches and inputs with
``fits_one_card`` against the card's memory, and ``bound_ms``, the larger
of ``flops_min`` over the tensor cores' rates and ``bytes_min`` over the
memory rate (``launch.mesh``).

What the meta device cannot run, and what stands in for it here only:

* the quantized products: the kernels need data pointers, so under a
  quantized backend each ``quantized_matmul`` returns an empty result of
  its shape and records its (rows, K, N); its straight-through backward is
  the real one (float products, counted);
* the mixture-of-experts dispatch, which sorts and counts on the host: the
  experts run at their capacity, every one of them, as the JAX package's
  static-shaped graph computes them (``_moe_at_capacity``); the buffer's
  padding past the routed rows is counted apart, so that ``flops_min``
  and the bound leave it out (the port's ``nn.moe.apply`` multiplies only
  the experts that received tokens).

Counting is linear in the repeats of the block program and in the
microbatches, so by default the step is traced with none and with one
repeat of its repeated layer group (a train step: one and two), at one
microbatch, and extrapolated (``step_cost(..., exact=True)`` traces every
layer and microbatch; ``tests/test_torch_launch.py`` holds the two
equal). A windowed arch's ring takes at most its window of
prompt tokens (``nn.attention`` refuses more), so its prefill cell counts
a cache-free prefill: the same products, no cache written.

With ``--mesh 16x16`` or ``--mesh 2x16x16`` (the JAX package's production
meshes, ``launch.mesh.production_layout``, planned: no rank runs) each
record also holds ``state_bytes_per_rank``: one rank's shards of the
parameters, gradients, optimizer state, caches and inputs by the JAX
package's shardings (``launch.specs`` with ``mesh=``), and whether they
fit the card's memory. Such records are tagged ``..._mesh16x16`` and sit
beside the single-card ones, never over them. They count the state at
rest: the port's own sharded step (``train.steps``) gathers the whole
parameters and gradients on every rank for the length of a step.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --shape decode_32k      # every arch
  python -m repro_torch.launch.dryrun --all [--quant approx_deficit_pallas]
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape \
      train_4k --mesh 2x16x16
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.launch import mesh
from repro_torch.launch import specs as SP
from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.nn import conv as CONV
from repro_torch.nn import layers as L
from repro_torch.nn import moe as MOE
from repro_torch.optim import adamw
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import for_lm
from repro_torch.train import steps as ST

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch" / \
    "dryrun"
BIG_D_MODEL = 4096          # train cells of d_model >= this microbatch
BIG_MICROBATCHES = 8
POSITIONAL = ("k", "v", "ckv", "kpe")   # cache leaves indexed by position


def projection_shapes(cfg: ArchConfig) -> List[tuple]:
    """(K, N) of every quantized product of one forward, in launch order:
    the attention's (GQA q, k, v, o; MLA wq, wdkv, wo), the dense MLP's
    (gate, up, down; a mixture-of-experts layer's products are float), and
    the head; RWKV6's time mix (r, k, v, g, o) and channel mix (k, v, r);
    hymba's attention, Mamba (in, x, out) and MLP. A cross layer's k and v
    take the projected encoder states (d_model wide); a gelu MLP has up and
    down; musicgen's codebook head is a float product."""
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.dh
    qd = cfg.n_heads * cfg.dh
    if cfg.ssm == "rwkv6":
        layer = [(d, d)] * 5 + [(d, f), (f, d), (d, d)]
        return layer * cfg.n_layers + [(d, cfg.padded_vocab)]
    if cfg.ssm == "hymba":
        mc = cfg.mamba_cfg()
        layer = [(d, qd), (d, kvd), (d, kvd), (qd, d),
                 (d, 2 * mc.d_inner),
                 (mc.d_inner, mc.dt_rank + 2 * mc.n_state), (mc.d_inner, d),
                 (d, f), (d, f), (f, d)]
        return layer * cfg.n_layers + [(d, cfg.padded_vocab)]
    if cfg.kv_lora:
        layer = [(d, cfg.n_heads * (cfg.qk_nope + cfg.qk_rope)),
                 (d, cfg.kv_lora + cfg.qk_rope),
                 (cfg.n_heads * cfg.v_head_dim, d)]
    else:
        layer = [(d, qd), (d, kvd), (d, kvd), (qd, d)]
    if not cfg.n_experts:
        layer += ([(d, f), (d, f), (f, d)] if cfg.mlp_act in ("swiglu",
                                                              "geglu")
                  else [(d, f), (f, d)])
    head = [] if cfg.n_codebooks > 1 else [(d, cfg.padded_vocab)]
    return layer * cfg.n_layers + head


# ---------------------------------------------------------------------------
# The meta-device stand-ins
# ---------------------------------------------------------------------------

class _MetaQuantizedMatmul(QM._QuantizedMatmul):
    """``quantized_matmul`` on the meta device: an empty result of the
    product's shape, the product's (rows, K, N) recorded in
    ``products``; the backward is ``_QuantizedMatmul``'s."""
    products: Optional[list] = None

    @staticmethod
    def forward(ctx, x, w, bias, cfg, activation):
        rows = x.numel() // x.shape[-1]
        _MetaQuantizedMatmul.products.append((rows, x.shape[-1], w.shape[1]))
        y = x.new_empty(x.shape[:-1] + (w.shape[1],))
        ctx.activation = activation
        ctx.bias_like = None if bias is None else (bias.shape, bias.dtype)
        ctx.save_for_backward(x, w, y if activation == "relu" else None)
        return y


def _meta_quantized_matmul(x, w, cfg, bias=None, activation=None):
    return _MetaQuantizedMatmul.apply(x, w, bias, cfg, activation)


class _Padding(torch.autograd.Function):
    """Identity on the experts' capacity buffer that adds to ``flops`` the
    products the buffer's padding costs: its forward once (again under
    remat's recomputation), its backward once for each of the buffer and
    the weights that takes a gradient, as the einsums it stands before."""
    flops: Optional[list] = None

    @staticmethod
    def forward(ctx, buf, w, pad):
        _Padding.flops[0] += pad
        ctx.pad = pad
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, g):
        _Padding.flops[0] += ctx.pad * sum(ctx.needs_input_grad[:2])
        return g, None, None


def routed_pairs(cfg: MOE.MoEConfig, s: int) -> int:
    """(token, expert) pairs one group of ``s`` tokens can keep: each
    token's top_k, at most the capacity of every expert (drops beyond it
    depend on the data and are not subtracted)."""
    cap = int(max(1, round(s * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    return min(s * cfg.top_k, cfg.n_experts * cap)


def _moe_at_capacity(params, x, cfg: MOE.MoEConfig, quant, qat=False):
    """``nn.moe.apply``'s products at static shapes: the router, every
    expert at the group's capacity (the JAX package's einsums over the
    (B, E, capacity, D) buffer) and the shared experts; dispatch and
    combine move rows by index (no product). The buffer's rows past the
    routed pairs are padding, counted apart (``_Padding``)."""
    del quant
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    f32 = torch.float32
    probs = torch.softmax(torch.einsum(
        "bsd,de->bse", x.to(f32), params["router"].to(f32)), dim=-1)
    gates, _ = torch.topk(probs, K, dim=-1)
    aux = cfg.router_aux_weight * E * torch.sum(probs.mean(dim=(0, 1)))
    cap = int(max(1, round(s * K / E * cfg.capacity_factor)))
    rows = torch.zeros((E * cap,), dtype=torch.int64, device=x.device)
    buf = x.index_select(1, rows).reshape(b, E, cap, d).to(f32)
    w1, w3, w2 = MOE._experts(params, cfg, qat)
    buf = _Padding.apply(buf, w1, 2 * 3 * b * (E * cap - routed_pairs(
        cfg, s)) * d * cfg.d_ff)
    h = torch.einsum("becd,edf->becf", buf, w1.to(f32))
    u = torch.einsum("becd,edf->becf", buf, w3.to(f32))
    act = (F.silu(h) * u).to(x.dtype)
    y = torch.einsum("becf,efd->becd", act.to(f32), w2.to(f32)).to(x.dtype)
    picks = torch.zeros((s * K,), dtype=torch.int64, device=x.device)
    out = (y.reshape(b, E * cap, d).index_select(1, picks)
           * gates.reshape(b, s * K, 1).to(x.dtype)).reshape(b, s, K, d)
    out = out.sum(dim=2)
    if cfg.n_shared:
        hs = MOE._f32mm(x, params["shared_w1"]).to(x.dtype)
        us = MOE._f32mm(x, params["shared_w3"]).to(x.dtype)
        out = out + MOE._f32mm((F.silu(hs) * us).to(x.dtype),
                               params["shared_w2"]).to(x.dtype)
    return out, aux


@contextlib.contextmanager
def _meta_step(products: list, padding: list):
    """For the length of a ``with``: the stand-ins in place of the
    quantized products and the mixture-of-experts layer (recording into
    ``products`` and ``padding``), and AdamW
    updating each leaf whole (its row slices bound float32 temporaries,
    which the meta device does not hold; the update counts no product)."""
    saved = (L.quantized_matmul, CONV.quantized_matmul, MOE.apply,
             adamw.UPDATE_SLICE)
    _MetaQuantizedMatmul.products = products
    _Padding.flops = padding
    L.quantized_matmul = CONV.quantized_matmul = _meta_quantized_matmul
    MOE.apply = _moe_at_capacity
    adamw.UPDATE_SLICE = 1 << 62
    try:
        yield
    finally:
        (L.quantized_matmul, CONV.quantized_matmul, MOE.apply,
         adamw.UPDATE_SLICE) = saved
        _MetaQuantizedMatmul.products = _Padding.flops = None


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def _run_step(cfg: ArchConfig, kind: str, batch: int, seq: int, *, pos,
              max_len: int, qat: bool, microbatches: int, cache_dtype):
    """One step of ``kind`` on the meta device under the FLOP counter.
    Returns (flops, [(rows, K, N) of each quantized product], the FLOPs
    of the experts' capacity padding)."""
    params = SP.meta_tree(TLM.descs(cfg))
    inp = SP.step_inputs(cfg, kind, batch, seq)
    products: list = []
    padding = [0]
    with _meta_step(products, padding), FlopCounterMode(display=False) as fc:
        if kind == "train":
            ocfg = adamw.AdamWConfig(quantized_state=True)
            opt = SP.meta_tree(adamw.state_descs(TLM.descs(cfg), ocfg))
            ST.make_train_step(cfg, ocfg, num_microbatches=microbatches,
                               qat=qat)(params, opt, inp)
        elif kind == "prefill":
            cache = (None if _cache_free_prefill(cfg, seq, max_len) else
                     TLM.init_cache(cfg, batch, max_len, cache_dtype,
                                    device=SP.META))
            TLM.prefill(params, inp["tokens"], cfg, cache, enc=inp.get("enc"))
        else:
            cache = TLM.init_cache(cfg, batch, max_len, cache_dtype,
                                   device=SP.META)
            ST.make_serve_step(cfg)(params, cache, inp["tokens"], pos,
                                    enc=inp.get("enc"))
    return fc.get_total_flops(), products, padding[0]


def _cache_free_prefill(cfg: ArchConfig, seq: int, max_len: int) -> bool:
    limit = TLM.prefill_limit(cfg, max_len)
    return limit is not None and seq > limit


def _depths(cfg: ArchConfig, base: int):
    """(depth of ``base`` repeats, of ``base`` + 1, repeats) of the block
    program's repeated group, its remainder group kept; None when the
    program has too few repeats to gain from extrapolating."""
    rep, kinds = cfg.blocks()[0]
    rem = cfg.n_layers - rep * len(kinds)
    if rep < base + 2:
        return None
    return base * len(kinds) + rem, (base + 1) * len(kinds) + rem, rep


def _state_bytes(cache) -> Dict[str, int]:
    """Per-row bytes of one position of the position-indexed leaves, their
    slot counts, and per-row bytes of the state leaves, of a cache tree."""
    per_pos: Dict[int, int] = {}
    state = 0
    for path, t in adamw.flatten(cache):
        if path[-1] in POSITIONAL:
            slots = t.shape[2]
            per_pos[slots] = per_pos.get(slots, 0) + (
                t.shape[0] * t[0, 0, 0].numel() * t.element_size())
        else:
            state += t.shape[0] * t[0, 0].numel() * t.element_size()
    return {"per_position": per_pos, "state": state}


def _unrouted_bytes(cfg: ArchConfig, params, groups: int, s: int) -> int:
    """Bytes of the expert weights that ``groups`` groups of ``s`` tokens
    cannot reach: each mixture-of-experts layer multiplies at most
    ``groups x routed_pairs`` of its experts (``nn.moe.apply`` skips the
    rest)."""
    mc = cfg.moe_cfg()
    used = min(mc.n_experts, groups * routed_pairs(mc, s))
    return sum(t.numel() * t.element_size() for path, t
               in adamw.flatten(params)
               if path[-2] == "moe" and path[-1] in ("w1", "w2", "w3")
               ) * (mc.n_experts - used) // mc.n_experts


def _io_bytes(cfg: ArchConfig, kind: str, batch: int, seq: int, *, pos,
              max_len: int, qat: bool, cache_dtype) -> Dict[str, int]:
    """The bytes a step must move: each input read once, each output
    written once (see the module docstring)."""
    params = SP.meta_tree(TLM.descs(cfg))
    inp = SP.step_inputs(cfg, kind, batch, seq)
    inp.pop("pos", None)
    out = {"params": SP.nbytes(params), "inputs": SP.nbytes(inp),
           "cache_read": 0, "cache_written": 0}
    if kind != "train" and cfg.n_experts:
        out["params"] -= _unrouted_bytes(cfg, params, batch,
                                         seq if kind == "prefill" else 1)
    codes = cfg.n_codebooks if cfg.n_codebooks > 1 else 1
    if kind == "train":
        ocfg = adamw.AdamWConfig(quantized_state=True)
        out["optimizer"] = SP.nbytes(SP.meta_tree(
            adamw.state_descs(TLM.descs(cfg), ocfg)))
        out["outputs"] = out["params"] + out["optimizer"] + 4
        return out
    cache = TLM.init_cache(cfg, batch, max_len, cache_dtype, device=SP.META)
    st = _state_bytes(cache)
    if kind == "prefill":
        if not _cache_free_prefill(cfg, seq, max_len):
            out["cache_written"] = batch * (st["state"] + sum(
                b * min(seq, slots)
                for slots, b in st["per_position"].items()))
        out["outputs"] = batch * codes * cfg.padded_vocab * 4
        return out
    rows = [int(p) for p in (pos if isinstance(pos, (list, tuple))
                             else [pos] * batch)]
    out["cache_read"] = sum(
        st["state"] + sum(b * min(p + 1, slots)
                          for slots, b in st["per_position"].items())
        for p in rows)
    out["cache_written"] = batch * (st["state"] + sum(
        st["per_position"].values()))
    out["outputs"] = batch * codes * 4
    return out


def step_cost(cfg: ArchConfig, kind: str, batch: int, seq: int, *,
              pos=None, max_len: Optional[int] = None, qat: bool = False,
              microbatches: int = 1, cache_dtype=torch.bfloat16,
              exact: bool = False) -> dict:
    """FLOPs, bytes and bound of one step of ``kind`` at ``cfg``.

    train: ``batch`` rows of ``seq`` tokens, in ``microbatches``, a QAT
    step with ``qat``; prefill: ``batch`` prompts of ``seq`` tokens into a
    cache of ``max_len`` (default ``seq``) positions; decode: one token per
    row into a cache of ``max_len`` (default ``seq``) positions at ``pos``
    (a scalar or one position per row; default ``max_len - 1``). The
    projections run under ``cfg.quant``; ``exact`` traces every layer and
    microbatch instead of extrapolating (module docstring).

    ``flops`` counts the products as the JAX graph computes them, the
    experts at their capacity; ``flops_min``, which the bound takes, leaves
    out the capacity's padding (``routed_pairs``)."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown step kind {kind!r}")
    if batch % microbatches:
        raise ValueError(f"{microbatches} microbatches do not divide a "
                         f"batch of {batch}")
    max_len = max_len or seq
    if kind == "decode" and pos is None:
        pos = max_len - 1
    kw = dict(pos=pos, max_len=max_len, qat=qat, cache_dtype=cache_dtype)
    int8 = cfg.quant.is_quantized and not qat
    t0 = time.perf_counter()

    def count(c: ArchConfig) -> tuple:
        if exact:
            f, prods, pad = _run_step(c, kind, batch, seq,
                                      microbatches=microbatches, **kw)
            scale = 1
        else:
            f, prods, pad = _run_step(c, kind, batch // microbatches, seq,
                                      microbatches=1, **kw)
            scale = microbatches
        if kind == "decode" and int8:
            want = projection_shapes(c)
            if [p[1:] for p in prods] != want:
                raise RuntimeError(
                    f"{c.name}: the decode step's quantized products "
                    f"{[p[1:] for p in prods]} are not its projection "
                    f"list {want}")
        f_int8 = 2 * sum(r * k * n for r, k, n in prods)
        # the stand-in's forward counts nothing: its products are added
        return (scale * (f + f_int8), scale * f_int8, scale * len(prods),
                scale * pad)

    # a train step differentiates every block, so it keeps one repeat
    base = 1 if kind == "train" else 0
    depths = None if exact else _depths(cfg, base)
    if depths is None:
        flops, flops_int8, launches, pad = count(cfg)
        traced = [cfg.n_layers]
    else:
        l0, l1, rep = depths
        c0 = count(dataclasses.replace(cfg, n_layers=l0))
        c1 = count(dataclasses.replace(cfg, n_layers=l1))
        flops, flops_int8, launches, pad = (
            a + (rep - base) * (b - a) for a, b in zip(c0, c1))
        traced = [l0, l1]
    io = _io_bytes(cfg, kind, batch, seq, **kw)
    bytes_min = (io["params"] + io["inputs"] + io["cache_read"]
                 + io["cache_written"] + io["outputs"]
                 + io.get("optimizer", 0))
    flops_int8 = flops_int8 if int8 else 0
    comp_s = mesh.compute_s(flops - pad, flops_int8)
    out = {"kind": kind, "batch": batch, "seq": seq, "max_len": max_len,
           "microbatches": microbatches, "quant": cfg.quant.backend,
           "qat": qat, "cache_dtype": str(cache_dtype).split(".")[-1],
           "flops": float(flops), "flops_min": float(flops - pad),
           "flops_int8": float(flops_int8),
           "int8_products": int(launches if int8 else 0),
           "bytes_min": int(bytes_min), "bytes": io,
           "bound_ms": mesh.bound_ms(flops - pad, flops_int8, bytes_min),
           "bound_by": ("operations" if comp_s >= bytes_min
                        / mesh.HBM_BYTES_PER_S else "bytes"),
           "depths_traced": traced,
           "count_s": time.perf_counter() - t0}
    if kind == "decode":
        out["pos"] = pos if isinstance(pos, int) else [int(p) for p in pos]
    if kind == "prefill":
        out["cache_free_prefill"] = _cache_free_prefill(cfg, seq, max_len)
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def state_bytes(cfg: ArchConfig, shape: str) -> Dict[str, int]:
    """Bytes of a cell's parameters, gradients, optimizer state (int8
    moments), caches and inputs (``launch.specs``)."""
    seq, batch, kind = registry.SHAPES[shape]
    if kind == "train":
        params, opt = SP.model_state_specs(
            cfg, adamw.AdamWConfig(quantized_state=True))
        out = {"params": SP.nbytes(params), "grads": SP.nbytes(params),
               "optimizer": SP.nbytes(opt), "caches": 0}
    else:
        out = {"params": SP.nbytes(SP.model_state_specs(cfg)), "grads": 0,
               "optimizer": 0, "caches": SP.nbytes(SP.cache_specs(cfg, shape))}
    out["inputs"] = SP.nbytes(SP.input_specs(cfg, shape))
    out["total"] = sum(out.values())
    return out


def state_bytes_per_rank(cfg: ArchConfig, shape: str, layout,
                         rules=SP.DEFAULT_RULES) -> Dict[str, int]:
    """One rank's bytes of a cell's state over ``layout`` (a
    ``MeshLayout`` or ``DeviceMesh``) by the JAX package's shardings: its
    shards of the parameters, of the gradients (sharded as the
    parameters), of the optimizer state (int8 moments), of the caches and
    of the inputs; ``total``, and ``fits`` against the card's memory."""
    seq, batch, kind = registry.SHAPES[shape]
    if kind == "train":
        params, opt, pspec, ospec = SP.model_state_specs(
            cfg, adamw.AdamWConfig(quantized_state=True), layout, rules)
        p = SP.shard_nbytes(params, pspec, layout)
        out = {"params": p, "grads": p,
               "optimizer": SP.shard_nbytes(opt, ospec, layout),
               "caches": 0}
    else:
        params, pspec = SP.model_state_specs(cfg, mesh=layout, rules=rules)
        caches, cspec = SP.cache_specs(cfg, shape, mesh=layout, rules=rules)
        out = {"params": SP.shard_nbytes(params, pspec, layout), "grads": 0,
               "optimizer": 0,
               "caches": SP.shard_nbytes(caches, cspec, layout)}
    inputs, ispec = SP.input_specs(cfg, shape, layout, rules)
    out["inputs"] = SP.shard_nbytes(inputs, ispec, layout)
    out["total"] = sum(out.values())
    out["fits"] = out["total"] <= mesh.DEVICE_MEMORY_BYTES
    return out


MESHES = {"16x16": False, "2x16x16": True}     # --mesh: multi_pod


def run_cell(arch: str, shape: str, quant: str = "bf16",
             out_dir: Path = OUT_DIR, mesh_name: Optional[str] = None
             ) -> dict:
    """Count one (arch x shape) cell and write its record; with
    ``mesh_name`` (a key of MESHES) also its per-rank state on that
    production mesh, under a tag of its own."""
    cfg = registry.get(arch)
    if quant != "bf16":
        cfg = dataclasses.replace(cfg, quant=for_lm(quant))
    seq, batch, kind = registry.SHAPES[shape]
    mb = BIG_MICROBATCHES if kind == "train" and cfg.d_model >= BIG_D_MODEL \
        else 1
    t0 = time.perf_counter()
    cost = step_cost(cfg, kind, batch, seq, microbatches=mb)
    state = state_bytes(cfg, shape)
    tag = f"{arch}_{shape}" + (f"_{quant}" if quant != "bf16" else "") + (
        f"_mesh{mesh_name}" if mesh_name else "")
    rec = {"arch": arch, "shape": shape, "kind": kind, "seq": seq,
           "batch": batch, "quant": quant, "tag": tag, **cost,
           "state_bytes": state,
           "fits_one_card": state["total"] <= mesh.DEVICE_MEMORY_BYTES,
           "device_memory_bytes": mesh.DEVICE_MEMORY_BYTES}
    if mesh_name:
        layout = mesh.production_layout(MESHES[mesh_name])
        rec["mesh"] = {"name": mesh_name, "axes": list(layout.mesh_dim_names),
                       "shape": list(layout.shape)}
        rec["state_bytes_per_rank"] = state_bytes_per_rank(cfg, shape,
                                                           layout)
    rec["host_s"] = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    print(f"[OK] {arch:24s} {shape:12s} flops={rec['flops']:.4e} "
          f"flops_min={rec['flops_min']:.4e} "
          f"int8={rec['flops_int8']:.3e} bytes_min={rec['bytes_min']:.4e} "
          f"bound={rec['bound_ms']:.3f}ms ({rec['bound_by']}) "
          f"state={state['total'] / 2 ** 30:.2f}GiB "
          f"fits_one_card={rec['fits_one_card']} "
          + (f"per_rank={rec['state_bytes_per_rank']['total'] / 2 ** 30:.2f}"
             f"GiB on {mesh_name} "
             f"fits={rec['state_bytes_per_rank']['fits']} "
             if mesh_name else "")
          + f"host={rec['host_s']:.1f}s", flush=True)
    return rec


def cells(arch: Optional[str], shape: Optional[str], all_: bool) -> list:
    archs = registry.ARCH_NAMES if (all_ or not arch) else [arch]
    return [(a, s) for a in archs
            for s in (registry.applicable_shapes(a) if (all_ or not shape)
                      else [shape])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=sorted(registry.SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch x applicable shape")
    ap.add_argument("--quant", default="bf16",
                    help="backend of the projections (bf16: float)")
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="directory of the records")
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="also count each rank's state on this production "
                         "mesh (records tagged _mesh<name>)")
    args = ap.parse_args(argv)
    todo = cells(args.arch, args.shape, args.all)
    t0 = time.perf_counter()
    failures = []
    for a, s in todo:
        try:
            run_cell(a, s, args.quant, args.out, args.mesh)
        except Exception as e:                      # noqa: BLE001
            traceback.print_exc()
            failures.append((a, s, repr(e)))
            print(f"[FAIL] {a} {s}: {e}", flush=True)
    print(f"{len(todo) - len(failures)} of {len(todo)} cells counted in "
          f"{time.perf_counter() - t0:.1f} s of host time")
    if failures:
        for f in failures:
            print(" ", f)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

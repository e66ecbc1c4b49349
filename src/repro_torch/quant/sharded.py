"""Mesh-sharded quantized matmul, bit-exact by construction, after the JAX
package's ``repro.quant.sharded``.

Every rank of the mesh runs the same code (SPMD) on the same full
operands, takes its block, runs the registered backend on it (on the card:
the CUDA kernels K1-K4 through the ``*_pallas`` entries), and the blocks
come back together by the two collectives of ``parallel.collectives``.
The result equals the single-device call bit for bit, for every
registered backend and every admissible (m, n, k) axis assignment:

  M/N sharding   each accumulator out[m, n] is computed by exactly one
                 rank from the full K contraction: the same integer ops as
                 on one device. A per-token scale sx[m] stays with its row,
                 a per-channel scale sw[n] with its column, and the
                 dequant / bias / ReLU epilogue is elementwise, so a block
                 through a fused kernel (K2, K4) gives the elements of the
                 single-device call; the float blocks are gathered as
                 bytes.
  K sharding     each rank computes an int32 partial sum over its K slice
                 (K1, K3 on the card), and an all_reduce adds the partials
                 in int32, exact in any order, before the epilogue runs on
                 the total. RANK1's correction stays exact under any K
                 split: the plain version sums in float64 far below 2^53,
                 and the kernel sums each K chunk of at most
                 ``k_exact_f32`` terms in int32; a K shard only shrinks the
                 chunks, and the chunk sums are int32 before the reduction.
  quantization   every rank quantizes the same full operands, as the JAX
                 package quantizes outside its shard_map: the scales are
                 max reductions, the same values wherever they run.

The epilogue keeps the single-device rounding order: per token
``(acc * sw) * sx``, then bias, then ReLU; per tensor ``acc * (sx * sw)``,
then bias, then ReLU. The fused kernels round the same way (a multiply,
then an add, each rounded), so the fused and unfused routes agree.
Forward only: serving and the parity checks drive the forward.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import axis_sizes, mesh_positions
from repro_torch.quant.matmul import get_backend, quantized_matmul
from repro_torch.quant.quantize import QuantConfig, abs_max_scale, quantize


def _usable(axis: Optional[str], dim: int, mesh) -> Optional[str]:
    """The axis if it exists on the mesh and divides ``dim``, else None:
    the divisibility fallback of ``parallel.sharding.prune_spec``."""
    if axis is None or axis not in tuple(mesh.mesh_dim_names):
        return None
    return axis if dim % axis_sizes(mesh)[axis] == 0 else None


def shard_plan(m: int, k: int, n: int, mesh,
               m_axis: Optional[str] = "data",
               n_axis: Optional[str] = "model",
               k_axis: Optional[str] = None
               ) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """The (m_axis, n_axis, k_axis) partition actually used for an (M, K) x
    (K, N) integer matmul: a requested axis that is absent from the mesh
    or does not divide its dim degrades to replication, and one mesh axis
    shards at most one dim (K wins over N, and M yields to both)."""
    k_ax = _usable(k_axis, k, mesh)
    n_ax = _usable(n_axis, n, mesh)
    m_ax = _usable(m_axis, m, mesh)
    if k_ax is not None and k_ax == n_ax:
        n_ax = None
    if m_ax is not None and m_ax in (k_ax, n_ax):
        m_ax = None
    return m_ax, n_ax, k_ax


def _block(t: torch.Tensor, dim: int, axis: Optional[str], mesh
           ) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axis``."""
    if axis is None:
        return t
    size = axis_sizes(mesh)[axis]
    step = t.shape[dim] // size
    return t.narrow(dim, mesh.get_local_rank(axis) * step, step)


def _gather(t: torch.Tensor, m_ax, n_ax, mesh) -> torch.Tensor:
    if n_ax is not None:
        t = C.all_gather_dim(t, mesh, n_ax, 1)
    if m_ax is not None:
        t = C.all_gather_dim(t, mesh, m_ax, 0)
    return t


def sharded_integer_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                           cfg: QuantConfig, mesh, *,
                           m_axis: Optional[str] = "data",
                           n_axis: Optional[str] = "model",
                           k_axis: Optional[str] = None) -> torch.Tensor:
    """Pre-dequant int32 matmul through ``cfg.backend``, partitioned over
    ``mesh``: x_q (M, K) int8, w_q (K, N) int8 -> (M, N) int32 on every
    rank, bit for bit ``integer_matmul(x_q, w_q, cfg)``."""
    m, k = x_q.shape
    n = w_q.shape[1]
    m_ax, n_ax, k_ax = shard_plan(m, k, n, mesh, m_axis, n_axis, k_axis)
    a = _block(_block(x_q, 0, m_ax, mesh), 1, k_ax, mesh).contiguous()
    b = _block(_block(w_q, 0, k_ax, mesh), 1, n_ax, mesh).contiguous()
    part = get_backend(cfg.backend).fn(a, b, cfg)
    if k_ax is not None:
        C.all_reduce_int32(part, mesh, k_ax)       # int32: exact
    return _gather(part, m_ax, n_ax, mesh)


def _epilogue(acc, sx, sw, bias, activation, per_token):
    y = acc.to(torch.float32)
    y = (y * sw) * sx if per_token else y * (sx * sw)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation == "relu":
        y = torch.clamp_min(y, 0.0)
    return y


def sharded_quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                             cfg: QuantConfig, mesh=None,
                             bias: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None, *,
                             m_axis: Optional[str] = "data",
                             n_axis: Optional[str] = "model",
                             k_axis: Optional[str] = None) -> torch.Tensor:
    """Shard-aware ``quantized_matmul``: float operands in, float out on
    every rank, bit for bit the single-device call for every backend.

    x (..., K) and w (K, N) are the full operands, the same on every rank.
    Without a K split, a backend with a fused epilogue (and
    ``cfg.fuse_epilogue``) runs it on the rank's block, as the single-device
    call does on the whole; with one, the backend's integer core runs on
    the block and the epilogue on the reduced int32 sums. ``mesh`` None or
    of one position falls back to ``quantized_matmul``."""
    if mesh_positions(mesh) <= 1:
        return quantized_matmul(x, w, cfg, bias, activation)
    if activation not in (None, "relu"):
        raise ValueError(f"unsupported activation {activation!r}")
    per_token = cfg.act_scale == "per_token"
    if not per_token and cfg.act_scale != "per_tensor":
        raise ValueError(f"unknown act_scale {cfg.act_scale!r}; "
                         "choose 'per_tensor' or 'per_token'")
    backend = get_backend(cfg.backend)
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    if cfg.per_channel:
        sw = abs_max_scale(w, axis=0, keepdims=True)       # (1, n)
    else:
        sw = abs_max_scale(w)
    w_q = quantize(w, sw).contiguous()
    x2 = x.reshape(-1, k)
    sx = abs_max_scale(x2, axis=-1 if per_token else None,
                       keepdims=per_token)                 # (M, 1) | scalar
    x_q = quantize(x2, sx).contiguous()
    m_ax, n_ax, k_ax = shard_plan(x2.shape[0], k, n, mesh, m_axis, n_axis,
                                  k_axis)
    if k_ax is not None or backend.fused is None or not cfg.fuse_epilogue:
        acc = sharded_integer_matmul(x_q, w_q, cfg, mesh, m_axis=m_axis,
                                     n_axis=n_axis, k_axis=k_axis)
        y = _epilogue(acc, sx, sw, bias, activation, per_token)
        return y.reshape(*lead, n).to(x.dtype)
    # the fused kernel on this rank's (rows, columns) block
    swf = sw.to(torch.float32).reshape(1, -1).expand(1, n)
    bias_f = (torch.zeros((1, n), dtype=torch.float32, device=x.device)
              if bias is None else bias.to(torch.float32).reshape(1, n))
    a = _block(x_q, 0, m_ax, mesh).contiguous()
    b = _block(w_q, 1, n_ax, mesh).contiguous()
    zeros = torch.zeros_like(_block(bias_f, 1, n_ax, mesh)).contiguous()
    if per_token:
        y = backend.fused(a, b, cfg, _block(swf, 1, n_ax, mesh).contiguous(),
                          zeros, False)
        y = y * _block(sx, 0, m_ax, mesh)
        if bias is not None:
            y = y + _block(bias_f, 1, n_ax, mesh)
        if activation == "relu":
            y = torch.clamp_min(y, 0.0)
    else:
        scale = (sx * swf).contiguous()
        y = backend.fused(a, b, cfg, _block(scale, 1, n_ax, mesh)
                          .contiguous(), _block(bias_f, 1, n_ax, mesh)
                          .contiguous(), activation == "relu")
    return _gather(y, m_ax, n_ax, mesh).reshape(*lead, n).to(x.dtype)


def make_sharded_matmul(cfg: QuantConfig, mesh, **axes):
    """``sharded_quantized_matmul`` closed over (cfg, mesh, axis
    assignment): the entry point of the parity harnesses."""
    return functools.partial(sharded_quantized_matmul, cfg=cfg, mesh=mesh,
                             **axes)

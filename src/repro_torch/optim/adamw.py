"""AdamW with optional int8 blockwise-quantized second moments.

The JAX package's update (``repro/optim/adamw.py``) on nested dicts (and
lists) of tensors, in its math and order: clip by the global norm over all
gradients (summed in sorted-key order, as ``jax.tree.leaves`` flattens),
bias correction in float32 from an int32 step count, ``mhat /
(sqrt(vhat) + eps)``, weight decay added to the update of tensors of two
or more dims only, then ``p - lr * upd``. ``torch.optim.AdamW`` is not
this update: it rounds in another order and decays biases too.

Quantized mode (the 8-bit-Adam-style trick):
  m : bfloat16
  v : int8 code + fp32 blockwise scale over the last dim (block = 128)

A leaf of more than UPDATE_SLICE elements is updated in slices of whole
rows, so that the update's float32 temporaries stay one slice large (a
1.26 B-element expert leaf of deepseek-v2 would need some 30 GB of them at
once); every step of the update is elementwise or per block of the last
dim, so the numbers are the whole leaf's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.nn import module as M
from repro_torch.nn.module import ParamDesc

VBLOCK = 128
UPDATE_SLICE = 1 << 24   # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False    # int8 v / bf16 m


def flatten(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs of a nested tree of dicts and lists, dict keys
    sorted at every level and list items in order (an int in the path): the
    leaf order of ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        items = ((key, tree[key]) for key in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += flatten(sub, prefix + (key,))
    return out


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(key, int) for key in node):
        return [_listify(node[i]) for i in range(len(node))]
    return {key: _listify(sub) for key, sub in node.items()}


def unflatten(pairs) -> Dict:
    """Inverse of ``flatten``: int path items rebuild lists."""
    out: Dict = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _listify(out)


def _scale_desc(d: ParamDesc) -> ParamDesc:
    nb = -(-d.shape[-1] // VBLOCK)
    return dataclasses.replace(d, shape=d.shape[:-1] + (nb,), init="ones",
                               dtype=torch.float32)


def state_descs(param_descs, cfg: AdamWConfig):
    """The optimizer state of a parameter descriptor tree, as descriptors:
    per leaf the moments (bf16 m, int8 v codes and float32 v scales per
    block of the last dim in quantized mode; float32 m and v otherwise),
    and the int32 step count. ``launch.specs`` builds abstract states from
    it; ``init`` allocates exactly what it describes."""
    def per_param(d: ParamDesc):
        zero = dataclasses.replace(d, init="zeros")
        if cfg.quantized_state:
            return {"m": dataclasses.replace(zero, dtype=torch.bfloat16),
                    "v_q": dataclasses.replace(zero, dtype=torch.int8),
                    "v_scale": _scale_desc(d)}
        return {"m": dataclasses.replace(zero, dtype=torch.float32),
                "v": dataclasses.replace(zero, dtype=torch.float32)}
    return {"params": M.tree_map(per_param, param_descs),
            "count": ParamDesc((1,), (None,), "zeros", dtype=torch.int32)}


def init(params, cfg: AdamWConfig):
    """Zero moments (unit v scales) for every leaf, and a zero step count,
    on the parameters' device: ``state_descs`` of the parameters' shapes
    and dtypes, allocated."""
    pairs = flatten(params)
    dev = pairs[0][1].device if pairs else torch.device("cpu")
    descs = unflatten((path, ParamDesc(tuple(p.shape), (None,) * p.ndim,
                                       dtype=p.dtype))
                      for path, p in pairs)
    return M.init_params(state_descs(descs, cfg), None, dev)


def _pad_blocks(t: torch.Tensor) -> torch.Tensor:
    """(..., last) -> (..., nb, VBLOCK), zero-padded past ``last``."""
    pad = (-t.shape[-1]) % VBLOCK
    return Fn.pad(t, (0, pad)).reshape(*t.shape[:-1], -1, VBLOCK)


def _quantize_v(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v (.., last) fp32 -> (int8 codes same shape, fp32 scales (.., nb))."""
    last = v.shape[-1]
    vb = _pad_blocks(v)
    scale = vb.amax(dim=-1) / 127.0 + 1e-20          # v >= 0
    q = torch.round(vb / scale[..., None]).to(torch.int8)
    return q.reshape(*v.shape[:-1], -1)[..., :last], scale


def _dequantize_v(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize with a scale-aware floor: values that rounded to code 0
    are restored as scale/4 instead of 0, so a consistently-small second
    moment in a block with a large max cannot make vhat ~ 0 and the update
    explode to mhat/eps."""
    last = q.shape[-1]
    vb = _pad_blocks(q).to(torch.float32)
    v = torch.clamp_min(vb, 0.25) * scale[..., None]
    return v.reshape(*q.shape[:-1], -1)[..., :last]


def global_norm(leaves) -> torch.Tensor:
    """The float32 L2 norm over every element of ``leaves``, leaf sums
    added in the given order. Each leaf is summed in row-major order (made
    contiguous first): a reduction follows the memory layout, and autograd
    may return a gradient in a transposed one, so the norm is a function of
    the values alone, whatever their strides (a sharded step's gradients
    arrive contiguous from the gather)."""
    return torch.sqrt(sum(torch.sum(torch.square(
        x.to(torch.float32).contiguous())) for x in leaves))


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, grad_norm=None):
    """One AdamW step. Returns (new_params, new_state). ``grad_norm``, the
    clip's global norm, defaults to ``global_norm`` of ``grads``; a
    sharded step passes the norm of the whole gradient and updates its
    shards (every step of the update is elementwise or per block of the
    last dim)."""
    count = state["count"] + 1
    cf = count[0].to(torch.float32)
    flat_g = flatten(grads)
    gnorm = (global_norm([g for _, g in flat_g]) if grad_norm is None
             else grad_norm)
    if cfg.grad_clip:
        # a tensor numerator: python / tensor would multiply by a rounded
        # reciprocal instead of dividing
        clip = torch.clamp_max(
            torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), 1.0)
    else:
        clip = 1.0
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device)
    corr1 = 1 - b1 ** cf
    corr2 = 1 - b2 ** cf

    def rows(g, st, p, decay: bool):
        g = g.to(torch.float32) * clip
        m = st["m"].to(torch.float32)
        v = (_dequantize_v(st["v_q"], st["v_scale"])
             if cfg.quantized_state else st["v"])
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / corr1
        vhat = v / corr2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:                            # decay matrices only
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - cfg.lr * upd).to(p.dtype)
        if cfg.quantized_state:
            q, scale = _quantize_v(v)
            return new_p, {"m": m.to(torch.bfloat16), "v_q": q,
                           "v_scale": scale}
        return new_p, {"m": m, "v": v}

    def per_param(g, st, p):
        decay = p.ndim >= 2
        if p.numel() <= UPDATE_SLICE or p.ndim < 2:
            return rows(g, st, p, decay)
        # every step is elementwise or per block of the last dim, so
        # slices of whole rows give the whole leaf's numbers, with float32
        # temporaries of one slice
        def flat(t):
            return t.reshape(-1, t.shape[-1])

        new_p = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        new_st = {k: torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for k, t in st.items()}
        g2, p2 = flat(g), flat(p)
        st2 = {k: flat(t) for k, t in st.items()}
        out_p, out_st = flat(new_p), {k: flat(t) for k, t in new_st.items()}
        step = max(1, UPDATE_SLICE // p.shape[-1])
        for r0 in range(0, p2.shape[0], step):
            sl = slice(r0, r0 + step)
            p1, s1 = rows(g2[sl], {k: t[sl] for k, t in st2.items()},
                          p2[sl], decay)
            out_p[sl] = p1
            for k, t in s1.items():
                out_st[k][sl] = t
        return new_p, new_st

    flat_s = dict(flatten(state["params"], ()))
    flat_p = dict(flatten(params))
    new_p, new_s = [], []
    for path, g in flat_g:
        st = {k: flat_s[path + (k,)] for k in _state_keys(cfg)}
        p1, s1 = per_param(g, st, flat_p[path])
        new_p.append((path, p1))
        new_s.append((path, s1))
    return unflatten(new_p), {"params": unflatten(new_s), "count": count}


def _state_keys(cfg: AdamWConfig) -> Tuple[str, ...]:
    return ("m", "v_q", "v_scale") if cfg.quantized_state else ("m", "v")

"""Carry parameters between the JAX package and the port.

The JAX package's parameter pytrees are nested dicts and lists (the
transformer LM keeps its stacked layer groups in a ``blocks`` list); passed
through numpy (``jax.tree.map(np.asarray, params)``) they become the port's
trees of tensors with the same keys, shapes and layouts. bfloat16 leaves
(numpy arrays of the ``bfloat16`` extension dtype) carry across bit for bit
through a 16-bit integer view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.module import resolve_device


def _tensor(node) -> torch.Tensor:
    arr = np.asarray(node)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(np_tree, device="cuda"):
    """Tree of dicts and lists of numpy arrays -> the same tree of tensors
    on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _tensor(node).to(dev)

    return conv(np_tree)


def params_to_numpy(tree):
    """Tree of dicts and lists of tensors -> the same tree of numpy arrays;
    the inverse of ``params_from_jax``, except that bfloat16 leaves come
    back as float32 arrays (exactly: bfloat16 is a subset of float32), since
    numpy has no bfloat16 of its own."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return {k: params_to_numpy(v) for k, v in tree.items()}

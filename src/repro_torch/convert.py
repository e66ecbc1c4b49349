"""Carry parameters between the JAX package and the port.

The JAX package's parameter pytrees are nested dicts; passed through
numpy (``jax.tree.map(np.asarray, params)``) they become the port's
nested dicts of tensors with the same keys, shapes and layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.module import resolve_device


def params_from_jax(np_tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(np_tree)


def params_to_numpy(tree):
    """Nested dict (or nn.Module dicts) of tensors -> nested dict of numpy
    arrays; the inverse of ``params_from_jax``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return {k: params_to_numpy(v) for k, v in tree.items()}

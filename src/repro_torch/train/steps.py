"""Train and serve steps for the transformer LM, after the JAX
package's ``repro.train.steps``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradients by autograd (the
quantized matmuls' straight-through backward; fake-quant under ``qat``),
then one AdamW update, under ``cnn_train.training_numerics`` (no TF32).
The reference jits it; here it runs eagerly, on the device of its
tensors. It takes no sharding rules yet (training over a mesh is ROADMAP.md
queue A, item 23).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.optim import adamw
from repro_torch.train.cnn_train import training_numerics, value_and_grad


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    num_microbatches: int = 1, qat: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, {"loss": loss}).

    ``batch`` holds ``tokens`` (B, S) ids, or ``embeds`` (B, S, D) stub
    embeddings, and ``labels``: (B, S), or (B, S, C) with ``n_codebooks``
    = C > 1; and ``enc`` (B, Se, enc_dim), the encoder states, for a
    config with cross-attention layers. With ``num_microbatches`` > 1
    every key is split along B, the gradients are summed in float32 and
    averaged, as the reference's scan does at its default
    ``accum_dtype``."""

    def loss_fn(params, batch):
        return TLM.forward_loss(params, batch, cfg, qat=qat, training=True)

    def train_step(params, opt_state, batch):
        with training_numerics():
            if num_microbatches > 1:
                parts = {k: torch.chunk(v, num_microbatches)
                         for k, v in batch.items()}
                grads, loss = None, 0.0
                for i in range(num_microbatches):
                    mb = {k: v[i] for k, v in parts.items()}
                    l_i, g = value_and_grad(loss_fn, params, mb)
                    flat = adamw.flatten(g)
                    if grads is None:
                        grads = [(p, t.to(torch.float32)) for p, t in flat]
                    else:
                        grads = [(p, a + t.to(torch.float32))
                                 for (p, a), (_, t) in zip(grads, flat)]
                    loss = loss + l_i
                grads = adamw.unflatten(
                    (p, a / num_microbatches) for p, a in grads)
                loss = loss / num_microbatches
            else:
                loss, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss}

    return train_step


def make_serve_step(cfg: ArchConfig):
    """(params, caches, token, pos, enc=None) -> (next token, caches): one
    greedy decode step over a batch of requests. ``token`` is (B, 1) ids or
    (B, 1, D) stub embeddings; ``enc`` the encoder states of a
    cross-attention config. The next token is (B, 1) int32, or (B, C), one
    code per codebook, with ``n_codebooks`` = C > 1."""

    def serve_step(params, caches, token, pos, enc=None):
        logits, caches = TLM.decode_step(params, token, pos, cfg, caches,
                                         enc=enc)
        last = logits[:, -1] if cfg.n_codebooks > 1 else logits[:, -1:]
        return torch.argmax(last, dim=-1).to(torch.int32), caches

    return serve_step

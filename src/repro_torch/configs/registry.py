"""Architecture registry: --arch lookup, vocab padding, reduced configs,
after the JAX package's ``repro.configs.registry``.

``SHAPES`` names the JAX package's four LM cells (sequence, batch, kind),
and ``applicable_shapes(name)`` the ones an arch runs (``long_500k`` only
for sub-quadratic archs). ``get(name)`` returns the full published config (vocab padded to a
multiple of 256; logits are masked back to the true vocab). ``reduced(name)``
returns a tiny same-family config for CPU tests (the same code paths).
The port runs every name of ``ARCH_NAMES``: the dense global-attention
families, gemma3's windowed ring buffer, the MLA / mixture-of-experts
families, the SSM families (rwkv6, hymba), llama-3.2-vision's
cross-attention and musicgen's stub embeddings and codebook heads.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.transformer_lm import ArchConfig

_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "smollm-135m": "smollm_135m",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen1.5-32b": "qwen15_32b",
    "gemma3-27b": "gemma3_27b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "rwkv6-3b": "rwkv6_3b",
    "musicgen-large": "musicgen_large",
}

ARCH_NAMES = tuple(_MODULES)

# LM shape set (assignment): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def _pad_vocab(v: int, mult: int = 256) -> int:
    return ((v + mult - 1) // mult) * mult


def get(name: str, **overrides) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    cfg: ArchConfig = importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG
    if cfg.vocab_pad == 0 and cfg.vocab % 256:
        cfg = dataclasses.replace(cfg, vocab_pad=_pad_vocab(cfg.vocab))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def reduced(name: str, **overrides) -> ArchConfig:
    """Tiny same-family config: the same code paths on the CPU, sized as
    the reference's ``reduced`` sizes them (one whole 5:1 group for
    gemma3 and one whole group of four self layers and a cross layer for
    llama-3.2-vision, 8 experts, a window of 8, a 32-wide MLA latent,
    encoder states of 16 x 64; rwkv6 keeps its chunked WKV, hymba its
    state of 16 and one KV head, musicgen its 4 codebooks)."""
    cfg = get(name)
    pattern = max(cfg.cross_every,
                  cfg.local_ratio + 1 if cfg.local_ratio else 0)
    heads = 4
    kv = (max(1, heads // (cfg.n_heads // cfg.n_kv_heads))
          if cfg.n_kv_heads < cfg.n_heads else heads)
    small = dict(
        n_layers=max(2, pattern), d_model=128, n_heads=heads,
        n_kv_heads=kv, d_ff=256, vocab=512, vocab_pad=512, head_dim=32,
        enc_dim=64 if cfg.enc_dim else 0,
        enc_len=16 if cfg.enc_len else 0,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        n_shared=min(1, cfg.n_shared),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        kv_lora=32 if cfg.kv_lora else 0,
        qk_nope=32, qk_rope=16, v_head_dim=32,
        local_window=8 if cfg.local_window else 0,
        param_dtype=torch.float32, remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def applicable_shapes(name: str):
    """Shape cells for this arch, as the JAX package's: long_500k only for
    sub-quadratic archs (compressed, windowed or recurrent state); an arch
    of full global attention skips it."""
    cfg = get(name)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out

"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf]. O(1)-state decode; the prefill runs the chunk-
parallel WKV (``nn/ssm.wkv_chunked``), decode its sequential step."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, ssm="rwkv6", sub_quadratic=True,
    rwkv_chunked=True,
    tied_embeddings=False, param_dtype=torch.bfloat16,
)

"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified]. GQA with 8 KV heads, full attention."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128,
    n_experts=384, top_k=8, n_shared=1, moe_d_ff=2048,
    tied_embeddings=False, param_dtype=torch.bfloat16,
)

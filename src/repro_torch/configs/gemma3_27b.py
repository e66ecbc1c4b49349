"""gemma3-27b [dense] — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3 family; unverified]. Only the 1-in-6 global layers keep a
full-length KV cache; local layers use a ring buffer of `local_window`."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=128, mlp_act="geglu",
    local_ratio=5, local_window=1024, sub_quadratic=True,
    tied_embeddings=True, param_dtype=torch.bfloat16,
)

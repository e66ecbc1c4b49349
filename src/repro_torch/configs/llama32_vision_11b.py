"""llama-3.2-vision-11b [vlm] — a cross-attention layer after every four
self-attention layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].
The vision frontend is a stub: the caller passes precomputed patch
embeddings (B, enc_len, enc_dim), which ``backbone`` projects to d_model
once per call."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
    cross_every=5, enc_dim=1280, enc_len=1601,
    param_dtype=torch.bfloat16,
)

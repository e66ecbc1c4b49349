"""musicgen-large [audio] — a decoder over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: the caller passes
precomputed frame embeddings (B, S, d_model); the 4 codebook heads share
the backbone and stay float, as in the reference."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=2048, head_dim=64, mlp_act="gelu",
    embed_stub=True, n_codebooks=4,
    param_dtype=torch.bfloat16,
)

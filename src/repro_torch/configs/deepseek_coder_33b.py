"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196; hf]."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab=32256, head_dim=128, rope_theta=100000.0, tied_embeddings=False,
    param_dtype=torch.bfloat16,
)

"""hymba-1.5b [hybrid] — parallel attention and Mamba heads in every layer
[arXiv:2411.13676; hf]. The attention is windowed (a ring of the window's
slots once the cache holds the whole window)."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, ssm="hymba", ssm_state=16,
    local_window=1024, sub_quadratic=True,
    param_dtype=torch.bfloat16,
)

"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]. MLA keeps the decode cache compressed to
(kv_lora + rope) per token."""
import torch

from repro_torch.models.transformer_lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab=102400,
    kv_lora=512, qk_nope=128, qk_rope=64, v_head_dim=128,
    n_experts=160, top_k=6, n_shared=2, moe_d_ff=1536,
    sub_quadratic=True,  # compressed-KV decode memory
    tied_embeddings=False, param_dtype=torch.bfloat16,
)

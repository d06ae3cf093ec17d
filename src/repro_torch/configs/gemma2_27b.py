"""gemma2-27b [dense]: alternating local(4096)/global attention, logit
softcaps, sandwich norms.  [arXiv:2408.00118]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    window_pattern=(4096, 0),
    attn_softcap=50.0,
    logit_softcap=30.0,
    query_scale=144.0,       # query_pre_attn_scalar = d_model / n_heads
    norm="rmsnorm",          # gemma (1 + w)
    post_norm=True,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
))

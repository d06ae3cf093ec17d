"""internvl2-76b [vlm]: InternLM2-76B decoder backbone; the InternViT
front-end is a stub — input_specs() hands the backbone precomputed patch
embeddings.  [arXiv:2404.16821]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    norm="rmsnorm_unit",
    mlp="swiglu",
    rope_theta=1_000_000.0,
    input_kind="embeds",
    param_dtype="bfloat16",
))

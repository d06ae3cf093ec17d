"""starcoder2-3b [dense]: GQA, RoPE, LayerNorm + bias MLP.
[arXiv:2402.19173]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    vocab_size=49_152,
    attn_bias=True,
    norm="layernorm",
    mlp="gelu",
    mlp_bias=True,
    rope_theta=999_999.0,
))

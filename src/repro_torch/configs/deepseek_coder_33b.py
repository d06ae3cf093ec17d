"""deepseek-coder-33b [dense]: llama-arch GQA.  [arXiv:2401.14196]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19_200,
    vocab_size=32_256,
    norm="rmsnorm_unit",
    mlp="swiglu",
    rope_theta=100_000.0,
    param_dtype="bfloat16",
))

"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    window_pattern=(4096,),
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=16_384,
    router="softmax",
    norm="rmsnorm_unit",
    mlp="swiglu",
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    moe_groups=16,
))

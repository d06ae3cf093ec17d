"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern (R,R,A).
[arXiv:2402.19427; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,          # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    window_pattern=(2048,),
    rglru_width=2560,
    conv_width=4,
    mlp="geglu",
    norm="rmsnorm",        # gemma-style (1 + w)
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
))

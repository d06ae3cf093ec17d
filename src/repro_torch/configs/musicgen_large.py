"""musicgen-large [audio]: decoder-only over EnCodec tokens; the EnCodec
front-end is a stub — input_specs() hands precomputed frame embeddings.
Sinusoidal positions, full MHA (kv=32).  [arXiv:2306.05284]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pos_emb="sinusoidal",
    norm="layernorm",
    mlp="gelu",
    input_kind="embeds",
))

"""mamba2-370m [ssm]: pure SSD mixer stack, attention-free.
[arXiv:2405.21060]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,             # unused (attention-free)
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    block_pattern=("ssd",),
    ffn_pattern="none",
    ssm_state=128,
    ssm_heads=32,          # expand=2 ⇒ d_inner=2048, head_dim 64
    ssm_head_dim=64,
    conv_width=4,
    norm="rmsnorm_unit",
    pos_emb="none",
    tie_embeddings=True,
))

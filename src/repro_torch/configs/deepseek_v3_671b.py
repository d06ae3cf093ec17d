"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed experts top-8,
sigmoid routing, first 3 layers dense.  MTP (multi-token prediction) is a
training-objective add-on and is NOT implemented — DESIGN.md records the
simplification.  [arXiv:2412.19437]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,            # qk_nope + qk_rope (bookkeeping)
    d_ff=18_432,             # dense layers (first 3)
    vocab_size=129_280,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    router="sigmoid_norm",
    capacity_factor=1.25,
    norm="rmsnorm_unit",
    mlp="swiglu",
    param_dtype="bfloat16",
    optimizer="adafactor",
    moe_groups=16,
))

"""Model/config schema and the architecture registry.

The port of `repro.configs.base`, field for field.  Every assigned
architecture is a `ModelConfig` in its own module; reduced ("smoke")
variants are derived mechanically for CPU tests.  Input shapes (the 4
assigned cells) are `ShapeSpec`s; `input_specs()` turns a (config ×
shape) cell into tensors on the ``meta`` device: shapes and dtypes, no
storage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 ⇒ d_model // n_heads
    # --- attention ---
    attn_kind: str = "gqa"  # gqa | mla
    attn_bias: bool = False
    pos_emb: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    query_scale: float = 0.0  # 0 ⇒ head_dim (gemma2 uses d_model/n_heads)
    window_pattern: tuple[int, ...] = (0,)  # cycled per attn layer; 0=global
    # --- MLA ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- norms / mlp ---
    norm: str = "rmsnorm"  # rmsnorm (gemma +1) | rmsnorm_unit | layernorm
    post_norm: bool = False  # gemma2 sandwich norms
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    mlp_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"  # softmax | sigmoid_norm
    moe_groups: int = 1
    aux_loss_coef: float = 0.01
    # --- SSM / recurrent ---
    block_pattern: tuple[str, ...] = ("attn",)  # cycled: attn | ssd | rglru
    ffn_pattern: str = "mlp"  # mlp | moe | none
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256  # SSD intra-chunk quadratic extent (§Perf C)
    conv_width: int = 4
    rglru_width: int = 0
    # --- modality front-end (stub) ---
    input_kind: str = "tokens"  # tokens | embeds (vlm/audio backbones)
    # --- numerics / execution ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"  # none | full
    optimizer: str = "adamw"  # adamw | adafactor
    # --- BLMAC integration ---
    quant_planes: int = 0  # >0 ⇒ CSD-P pulse-code serving quantization

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """Mechanically shrunken config for CPU smoke tests."""
        pat = len(self.block_pattern)
        small = dict(
            n_layers=max(pat + 1, 2) if pat > 1 else 2,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            moe_d_ff=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=32 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=32 if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_head_dim=16 if self.ssm_heads else 64,
            rglru_width=128 if self.rglru_width else 0,
            window_pattern=tuple(min(w, 64) if w else 0 for w in self.window_pattern),
            first_dense_layers=min(self.first_dense_layers, 1),
            moe_groups=1,
            # no capacity drops in smoke tests: keeps decode/forward parity
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            scan_layers=True,
            remat="none",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs for which long_500k is skipped (pure full attention — DESIGN.md)
LONG_CONTEXT_ARCHS = {
    "recurrentgemma-2b", "mamba2-370m", "mixtral-8x22b", "gemma2-27b",
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from . import ALL  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        from . import ALL  # noqa: F401
    return dict(_REGISTRY)


def cells_for(name: str) -> list[str]:
    """The shape cells this arch runs (40 total across the pool, minus
    documented long_500k skips)."""
    get_config(name)  # validate the arch name (raises on unknown)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if name in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """``meta``-device stand-ins for every model input of the cell — the
    reference's shapes and dtypes, no allocation."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.input_kind == "embeds":
            return {
                "embeds": spec((b, s, cfg.d_model), torch.bfloat16),
                "labels": spec((b, s), torch.int32),
                "mask": spec((b, s), torch.float32),
            }
        return {
            "tokens": spec((b, s), torch.int32),
            "labels": spec((b, s), torch.int32),
            "mask": spec((b, s), torch.float32),
        }
    if shape.kind == "prefill":
        if cfg.input_kind == "embeds":
            return {"embeds": spec((b, s, cfg.d_model), torch.bfloat16)}
        return {"tokens": spec((b, s), torch.int32)}
    # decode: one new token against a cache of seq_len
    if cfg.input_kind == "embeds":
        return {"embed": spec((b, 1, cfg.d_model), torch.bfloat16)}
    return {"token": spec((b, 1), torch.int32)}

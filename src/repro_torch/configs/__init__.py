"""Architecture registry of the port: one module per assigned
architecture, copies of `repro.configs`'s."""
# side-effect imports: each module registers its config at import time
from . import deepseek_coder_33b  # noqa: F401
from . import deepseek_v3_671b  # noqa: F401
from . import gemma2_27b  # noqa: F401
from . import internvl2_76b  # noqa: F401
from . import mamba2_370m  # noqa: F401
from . import mixtral_8x22b  # noqa: F401
from . import musicgen_large  # noqa: F401
from . import qwen2_5_3b  # noqa: F401
from . import recurrentgemma_2b  # noqa: F401
from . import starcoder2_3b  # noqa: F401
from .base import (
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    all_configs,
    cells_for,
    get_config,
    input_specs,
)
from .fir127 import FirConfig

ALL = list(all_configs())

__all__ = [
    "ALL", "LONG_CONTEXT_ARCHS", "SHAPES", "ModelConfig", "ShapeSpec",
    "FirConfig", "all_configs", "cells_for", "get_config", "input_specs",
]

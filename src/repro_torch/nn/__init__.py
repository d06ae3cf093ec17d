"""The language-model zoo in PyTorch: declaration-based params, stacked
per-stage layers, the reference's functions (`repro.nn`) one for one."""
from .common import (
    ParamDecl,
    ShardCtx,
    abstract_params,
    count_active_params,
    count_params,
    flatten_tree,
    init_params,
    param_pspecs,
    unflatten_tree,
)
from .convert import params_from_arrays
from .model import (LanguageModel, decode_step, forward, loss_fn,
                    loss_from_parts, loss_parts, model_decls, stage_plan)

__all__ = [
    "LanguageModel", "ParamDecl", "ShardCtx", "abstract_params",
    "count_active_params", "count_params", "decode_step", "flatten_tree",
    "forward", "init_params", "loss_fn", "loss_from_parts", "loss_parts",
    "model_decls", "param_pspecs", "params_from_arrays", "stage_plan",
    "unflatten_tree",
]

"""The train step's dot FLOPs, the port's `analyze_step` on ``meta``
tensors against `analyze_hlo` of the compiled reference, for all ten
archs reduced (2 layers, or the block pattern's), unsharded, B 2 × 64."""
import jax
import pytest

from repro.configs import ShapeSpec as RefShape
from repro.configs import all_configs
from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_specs
from repro.nn.model import model_decls as ref_decls
from repro.roofline.hlo_analysis import analyze_hlo
from repro.training.train_step import TrainHParams as RefHParams
from repro.training.train_step import abstract_train_state as ref_state
from repro.training.train_step import make_train_step as ref_step
from repro_torch.configs import ShapeSpec, get_config, input_specs
from repro_torch.nn import model_decls, stage_plan
from repro_torch.roofline import analyze_step
from repro_torch.training import (TrainHParams, abstract_train_state,
                                  make_train_step)

B, S = 2, 64


def _ref_flops(arch):
    rc = ref_config(arch).reduced()
    lowered = jax.jit(ref_step(rc, RefHParams())).lower(
        ref_state(rc, ref_decls(rc)),
        ref_specs(rc, RefShape("t", S, B, "train")))
    return analyze_hlo(lowered.compile().as_text()).flops


def _port_flops(arch):
    cfg = get_config(arch).reduced()
    return analyze_step(make_train_step(cfg, TrainHParams()),
                        abstract_train_state(cfg, model_decls(cfg)),
                        input_specs(cfg, ShapeSpec("t", S, B, "train"))
                        ).flops


def _ssd_gap(cfg) -> int:
    """The dot FLOPs the compiled reference's SSD backward has and the
    port's has not, a layer and a chunk: XLA recomputes the chunk's
    C·Bᵀ (2·B·Q·Q·N) in the scan's backward body where autograd keeps
    it, and takes the gradient of the (B, Q, H) decay factor of each of
    the two three-operand einsums (``y_off``, ``sb``) as a dot over the
    head dimension P (2·B·Q·H·P each) where autograd multiplies and
    sums."""
    q = min(cfg.ssm_chunk, S)
    while S % q:
        q -= 1
    n_ssd = sum(st.repeat * sum(m.mixer == "ssd" for m in st.metas)
                for st in stage_plan(cfg))
    per_chunk = (2 * B * q * q * cfg.ssm_state
                 + 2 * (2 * B * q * cfg.ssm_heads * cfg.ssm_head_dim))
    return n_ssd * (S // q) * per_chunk


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_train_step_dot_flops_equal_the_reference_hlo(arch):
    want, got = _ref_flops(arch), _port_flops(arch)
    cfg = get_config(arch).reduced()
    if any(m == "ssd" for m in cfg.block_pattern):
        # mamba2-370m: the port counts 0.97% fewer at this size, the SSD
        # backward's contractions above and nothing else
        gap = _ssd_gap(cfg)
        assert got == want - gap
        assert 0 < gap <= 0.01 * want
    else:
        assert got == want > 0

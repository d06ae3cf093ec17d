"""The port's Mixture-of-Experts FFN against `repro`.

`_positions_in_expert` exactly, on the reference's property (each
expert's slots ranked 0..n-1 in order of appearance) over seeded id
lists and against `repro`'s; `top_k`'s ties to the lower index; and
`moe_apply` — outputs, and the aux loss `switch_aux` makes of its
routing sums — with no drops, with capacity drops,
with both routers, with shared experts and with ``moe_groups > 1``.
Float32, the reference MoE test's tolerance: rtol 2e-4, atol 2e-4
(``tests/test_moe.py:57``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.nn import common as rcommon
from repro.nn import moe as rmoe
from repro_torch.configs import get_config as tget
from repro_torch.nn import common as tcommon
from repro_torch.nn import moe as tmoe
from torch_differential import ref_param_arrays

RTOL, ATOL = 2e-4, 2e-4


@pytest.mark.parametrize("n,n_experts,seed", [(1, 8, 0), (7, 8, 1),
                                              (64, 8, 2), (200, 8, 3),
                                              (200, 3, 4), (513, 256, 5)])
def test_positions_in_expert(n, n_experts, seed):
    e = np.random.default_rng(seed).integers(0, n_experts, n)
    pos = tmoe._positions_in_expert(torch.tensor(e), n_experts).numpy()
    assert pos.dtype == np.int32
    for ex in range(n_experts):
        got = pos[e == ex]
        assert np.array_equal(got, np.arange(len(got)))
    ref = np.asarray(rmoe._positions_in_expert(jnp.asarray(e), n_experts))
    assert np.array_equal(pos, ref)


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9], [1.0, 1.0, 1.0, 1.0, 1.0]])
    vals, idx = tmoe.top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ri))
    assert np.array_equal(vals.numpy(), np.asarray(rv))


CASES = {
    # (arch, overrides, tokens): no drops; drops (capacity 0.25); DeepSeek's
    # sigmoid router with a shared expert; 4 groups with drops
    "softmax": ("mixtral-8x22b", dict(capacity_factor=64.0), 24),
    "drops": ("mixtral-8x22b", dict(capacity_factor=0.25), 64),
    "sigmoid_shared": ("deepseek-v3-671b", dict(capacity_factor=2.0), 32),
    "groups": ("mixtral-8x22b", dict(capacity_factor=0.5, moe_groups=4), 48),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_the_reference(case):
    arch, over, t = CASES[case]
    kw = dict(d_model=32, moe_d_ff=16, n_experts=4, experts_per_token=2,
              **over)
    tcfg = dataclasses.replace(tget(arch).reduced(**kw),
                               compute_dtype="float32")
    rcfg = dataclasses.replace(rget(arch).reduced(**kw),
                               compute_dtype="float32")
    rp = rcommon.init_params(rmoe.moe_decls(rcfg), jax.random.key(0))
    tp = tcommon.unflatten_tree({k: torch.tensor(v) for k, v in
                                 ref_param_arrays(rp).items()})
    x = np.random.default_rng(0).standard_normal((2, t // 2, 32)) \
        .astype(np.float32)
    ry, raux = jax.jit(lambda p, x: rmoe.moe_apply(
        p, x, rcommon.ShardCtx(compute_dtype=jnp.float32), rcfg))(
            rp, jnp.asarray(x))
    ty, tsums = tmoe.moe_apply(tp, torch.tensor(x),
                               tcommon.ShardCtx(compute_dtype=torch.float32),
                               tcfg)
    taux = tmoe.switch_aux(tsums, x.shape[0] * x.shape[1], tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(raux), rtol=RTOL, atol=ATOL)
    if case in ("drops", "groups"):
        # slots past the capacity add nothing: some tokens get no routed
        # output at all, exactly as in the reference
        zero_t = (ty.abs().sum(-1) == 0).numpy()
        assert zero_t.any()
        assert np.array_equal(zero_t, np.abs(np.asarray(ry)).sum(-1) == 0)

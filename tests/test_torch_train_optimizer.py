"""The port's optimizers against `repro`'s: the schedule, the global-norm
clip, and AdamW and Adafactor fed the same gradients on 1-, 2- and 3-D
leaves for 3 steps (within 1e-6 of each leaf's scale), under the
reference's state trees and names; the port's updates work in place."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_differential import ref_param_arrays

from repro_torch.nn import flatten_tree
from repro_torch.training import OptHParams
from repro_torch.training.optimizer import (clip_by_global_norm, global_norm,
                                            make_optimizer, schedule)

HP = OptHParams(learning_rate=1e-2, warmup_steps=4, total_steps=12)
REL = 1e-6
SHAPES = {"bias": (7,), "w": (6, 5), "stack": (3, 4, 6)}


def _ref_hp(hp):
    from repro.training import OptHParams as ROpt

    return ROpt(**dataclasses.asdict(hp))


@pytest.mark.parametrize("step", [0, 1, 2, 4, 8, 12, 20])
def test_schedule_matches_the_reference(step):
    from repro.training import schedule as r_schedule

    got = schedule(HP, torch.tensor(step, dtype=torch.int32))
    want = np.asarray(r_schedule(_ref_hp(HP), jnp.int32(step)))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)
    if step == 0:
        assert got.item() == 0.0  # the warmup starts at lr 0
    if step >= HP.total_steps:
        assert got.item() == pytest.approx(HP.learning_rate
                                           * HP.min_lr_ratio, rel=1e-6)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("scale,clipped", [(0.01, False), (10.0, True)])
def test_clip_by_global_norm_matches_the_reference(scale, clipped):
    from repro.training.optimizer import clip_by_global_norm as r_clip

    arrays = _tree(0, scale)
    tree = {k: torch.tensor(v) for k, v in arrays.items()}
    leaves = {k: t.data_ptr() for k, t in tree.items()}
    rtree, rnorm = r_clip({k: jnp.asarray(v) for k, v in arrays.items()}, 1.0)
    out, norm = clip_by_global_norm(tree, 1.0)
    assert out is tree and all(t.data_ptr() == leaves[k]
                               for k, t in tree.items())
    np.testing.assert_allclose(norm.item(), float(rnorm), rtol=1e-6)
    assert (norm.item() > 1.0) == clipped
    for k, t in tree.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(rtree[k]),
                                   rtol=1e-6, atol=0)
        if not clipped:
            assert np.array_equal(t.numpy(), arrays[k])
    np.testing.assert_allclose(global_norm(tree).item(),
                               min(float(rnorm), 1.0), rtol=1e-5)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_the_reference(name):
    """Three steps from step 2 (past warmup's zero lr), the same
    gradients in both packages; params and state within 1e-6 of each
    leaf's scale, updated in place."""
    from repro.training.optimizer import make_optimizer as r_make

    r_init, r_update = r_make(name)
    init, update = make_optimizer(name)
    arrays = _tree(1)
    rparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    params = {k: torch.tensor(v) for k, v in arrays.items()}
    rstate, state = r_init(rparams), init(params)
    ptrs = [t.data_ptr() for t in flatten_tree({"p": params, "s": state})
            .values()]
    for i in range(3):
        grads = _tree(10 + i, scale=0.1)
        rparams, rstate = r_update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, rstate, rparams,
                                   jnp.int32(2 + i), _ref_hp(HP))
        out_p, out_s = update({k: torch.tensor(v) for k, v in grads.items()},
                              state, params, torch.tensor(2 + i), HP)
        assert out_p is params and out_s is state
        for got, want in ((params, rparams), (state, rstate)):
            ref = ref_param_arrays(want)
            flat = flatten_tree(got)
            assert set(flat) == set(ref)
            for k, t in flat.items():
                scale = np.abs(ref[k]).max()
                assert np.abs(t.numpy() - ref[k]).max() <= REL * scale, k
    assert ptrs == [t.data_ptr() for t in flatten_tree(
        {"p": params, "s": state}).values()]


def test_optimizer_state_trees_have_the_reference_names():
    from repro.training.optimizer import make_optimizer as r_make

    arrays = _tree(2)
    for name in ("adamw", "adafactor"):
        rstate = r_make(name)[0]({k: jnp.asarray(v)
                                  for k, v in arrays.items()})
        state = make_optimizer(name)[0]({k: torch.tensor(v)
                                         for k, v in arrays.items()})
        ref = ref_param_arrays(rstate)
        flat = flatten_tree(state)
        assert {k: tuple(t.shape) for k, t in flat.items()} \
            == {k: v.shape for k, v in ref.items()}
        assert all(t.dtype == torch.float32 for t in flat.values())
    assert set(flatten_tree(state)) == {"f/bias/v", "f/w/vr", "f/w/vc",
                                        "f/stack/vr", "f/stack/vc"}


def test_bf16_parameters_update_in_float32_and_round_once():
    """A bfloat16 leaf: the update in float32, the parameter rounded once
    to bfloat16, as the reference casts it back."""
    from repro.training.optimizer import adamw_init as r_init
    from repro.training.optimizer import adamw_update as r_update

    w = _tree(3)["w"]
    p = torch.tensor(w).to(torch.bfloat16)
    rp = jnp.asarray(w).astype(jnp.bfloat16)
    init, update = make_optimizer("adamw")
    state, rstate = init({"w": p}), r_init({"w": rp})
    g = _tree(4, 0.1)["w"]
    rnew, _ = r_update({"w": jnp.asarray(g)}, rstate, {"w": rp},
                       jnp.int32(5), _ref_hp(HP))
    update({"w": torch.tensor(g)}, state, {"w": p}, torch.tensor(5), HP)
    assert p.dtype == torch.bfloat16
    want = np.asarray(rnew["w"].astype(jnp.float32))
    np.testing.assert_array_equal(p.float().numpy(), want)


def test_make_optimizer_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")

"""Every registered architecture, reduced, through `repro` and the port.

For each of the ten archs (compute float32, the same parameters
converted from `repro`'s): the prefill's logits and caches (`forward`
with a cache, through `ServeEngine`'s prefill step), four decode steps'
logits and the caches after them, the loss value with its metrics (the
forward's MoE aux among them), `ServeEngine.generate`'s greedy tokens
(equal), and `abstract_caches` (equal to the reference's and to the
caches the prefill made).  Tolerance: the reference attention test's,
rtol 2e-4 and atol 2e-5, the tightest of its module tests; cache
positions and tokens exactly.
"""
import functools

import numpy as np
import pytest
import torch

from repro.configs import all_configs
from torch_differential import lm_case, ref_config

ARCHS = sorted(all_configs())
RTOL, ATOL = 2e-4, 2e-5


@functools.lru_cache(maxsize=None)
def _case(arch):
    return lm_case(arch)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


def _cache_leaves(caches):
    """(stage, slot, name) → leaf, over the stacked layout."""
    return {(si, j, k): leaf for si, st in enumerate(caches)
            for j, slot in enumerate(st) for k, leaf in slot.items()}


def _assert_caches(port, ref):
    p, r = _cache_leaves(port), _cache_leaves(ref)
    assert set(p) == set(r)
    for key, leaf in p.items():
        assert tuple(leaf.shape) == r[key].shape, key
        if key[2] == "pos":
            assert np.array_equal(leaf.numpy(), r[key]), key
        else:
            _close(leaf, r[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches(arch):
    case = _case(arch)
    assert tuple(case.port["prefill"].shape) == case.ref["prefill"].shape
    assert case.port["prefill"].dtype == torch.float32
    _close(case.port["prefill"], case.ref["prefill"])
    _assert_caches(case.port["caches"], case.ref["caches"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch):
    case = _case(arch)
    assert len(case.port["decode"]) == 4
    for got, want in zip(case.port["decode"], case.ref["decode"]):
        _close(got, want)
    _assert_caches(case.port["decode_caches"], case.ref["decode_caches"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_value_and_aux(arch):
    case = _case(arch)
    np.testing.assert_allclose(case.port["loss"], case.ref["loss"],
                               rtol=RTOL, atol=ATOL)
    for name, want in case.ref["metrics"].items():
        np.testing.assert_allclose(case.port["metrics"][name], want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if case.cfg.n_experts:
        assert case.port["metrics"]["aux"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_the_references_tokens(arch):
    case = _case(arch)
    got = case.port["generate"]
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 5)
    assert np.array_equal(got.numpy(), case.ref["generate"])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_caches(arch):
    from repro.serving.engine import abstract_caches as r_abstract
    from repro_torch.serving import abstract_caches

    case = _case(arch)
    got = abstract_caches(case.cfg, 3, 40)
    want = r_abstract(ref_config(case.cfg), 3, 40)
    g, w = _cache_leaves(got), _cache_leaves(want)
    assert set(g) == set(w)
    for key, leaf in g.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == w[key].shape, key
        assert str(leaf.dtype).removeprefix("torch.") == str(w[key].dtype)
    made = _cache_leaves(case.port["caches"])
    shapes = _cache_leaves(abstract_caches(case.cfg, 2, 32))
    assert {k: (tuple(v.shape), v.dtype) for k, v in made.items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in shapes.items()}

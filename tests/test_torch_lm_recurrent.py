"""The port's recurrent mixers against `repro`: the depthwise causal
conv1d and its BLMAC bit-layer evaluation, the chunked SSD at several
chunk sizes and its decode, the RG-LRU block (the reference's
associative scan against the port's float32 step-by-step scan) and its
decode, and the SSD gradient on a long chunk, finite in the port where
the reference's is NaN.  Float32; the reference's own tolerances: SSD 2e-3
(``tests/test_ssd_rglru.py:32``), RG-LRU rtol 1e-4 / atol 1e-5 (``:55``);
the conv at the RG-LRU one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.nn import common as rcommon
from repro.nn import rglru as rrglru
from repro.nn import ssd as rssd
from repro_torch.configs import get_config as tget
from repro_torch.nn import common as tcommon
from repro_torch.nn import rglru as trglru
from repro_torch.nn import ssd as tssd
from torch_differential import ref_param_arrays

SSD_TOL = 2e-3
RG_RTOL, RG_ATOL = 1e-4, 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _pair(decls_fn, arch, seed, **over):
    tcfg = dataclasses.replace(tget(arch).reduced(**over),
                               compute_dtype="float32")
    rcfg = dataclasses.replace(rget(arch).reduced(**over),
                               compute_dtype="float32")
    rp = rcommon.init_params(decls_fn(rcfg), jax.random.key(seed))
    tp = tcommon.unflatten_tree({k: _t(v) for k, v in
                                 ref_param_arrays(rp).items()})
    return tcfg, rcfg, tp, rp


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_and_its_bit_layers(with_tail):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_tail else None
    ry, rtail = rssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), None if tail is None
                                   else jnp.asarray(tail))
    ty, ttail = tssd.causal_conv1d(_t(x), _t(w), _t(b),
                                   None if tail is None else _t(tail))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=RG_RTOL,
                               atol=RG_ATOL)
    assert np.array_equal(ttail.numpy(), np.asarray(rtail))
    trits = rng.integers(-1, 2, (5, 4, 12)).astype(np.int8)
    ry, _ = rssd.blmac_conv1d(jnp.asarray(x), jnp.asarray(trits), 3,
                              jnp.asarray(b), None if tail is None
                              else jnp.asarray(tail))
    ty, _ = tssd.blmac_conv1d(_t(x), _t(trits), 3, _t(b),
                              None if tail is None else _t(tail))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=RG_RTOL,
                               atol=RG_ATOL)
    # the bit layers are the conv with weights Σ_L trits·2^(L−e)
    wq = (trits * 2.0 ** np.arange(5)[:, None, None]).sum(0) * 2.0 ** -3
    ty2, _ = tssd.causal_conv1d(_t(x), _t(wq.astype(np.float32)), _t(b),
                                None if tail is None else _t(tail))
    np.testing.assert_allclose(ty.numpy(), ty2.numpy(), rtol=RG_RTOL,
                               atol=RG_ATOL)


@pytest.mark.parametrize("chunk", [1, 4, 8, 23, 256])
def test_ssd_chunked_prefill_and_decode(chunk):
    tcfg, rcfg, tp, rp = _pair(rssd.ssd_decls, "mamba2-370m", 0,
                               d_model=48, ssm_heads=4, ssm_head_dim=8,
                               ssm_state=16)
    rng = np.random.default_rng(0)
    b, s = 2, 23
    x = (rng.standard_normal((b, s, 48)) * 0.3).astype(np.float32)
    ry, rc = rssd.ssd_apply(rp, jnp.asarray(x), rcommon.ShardCtx(
        compute_dtype=jnp.float32, make_cache=True), rcfg, None, chunk=chunk)
    ty, tc = tssd.ssd_apply(tp, _t(x), tcommon.ShardCtx(
        compute_dtype=torch.float32, make_cache=True), tcfg, None,
        chunk=chunk)
    for got, want in ((ty, ry), (tc["state"], rc["state"]),
                      (tc["conv_tail"], rc["conv_tail"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SSD_TOL, atol=SSD_TOL)
    ctx = tcommon.ShardCtx(compute_dtype=torch.float32)
    rctx = rcommon.ShardCtx(compute_dtype=jnp.float32)
    for step in range(3):
        xs = (rng.standard_normal((b, 1, 48)) * 0.3).astype(np.float32)
        ry, rc = rssd.ssd_decode(rp, jnp.asarray(xs), rc, rctx, rcfg, None)
        ty, tc = tssd.ssd_decode(tp, _t(xs), tc, ctx, tcfg, None)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=SSD_TOL,
                                   atol=SSD_TOL)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(rc["state"]),
                               rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_gradient_stays_finite_on_a_long_chunk():
    """On a chunk of 256 the intra-chunk decay's masked pairs reach
    exp(+150) and overflow: the reference takes ``where(causal,
    exp(li), 0)``, whose gradient there is 0·inf (NaN); the port masks
    before the exp, so its forward is the reference's and its gradient
    finite."""
    tcfg, rcfg, tp, rp = _pair(rssd.ssd_decls, "mamba2-370m", 2,
                               d_model=48, ssm_heads=4, ssm_head_dim=8,
                               ssm_state=16)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((1, 256, 48)) * 0.3).astype(np.float32)

    def rloss(xx):
        y, _ = rssd.ssd_apply(rp, xx, rcommon.ShardCtx(
            compute_dtype=jnp.float32), rcfg, None, chunk=256)
        return y.sum()

    rg = jax.grad(rloss)(jnp.asarray(x))
    assert not np.isfinite(np.asarray(rg)).all()
    tx = _t(x).requires_grad_()
    ty, _ = tssd.ssd_apply(tp, tx, tcommon.ShardCtx(
        compute_dtype=torch.float32), tcfg, None, chunk=256)
    ty.sum().backward()
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(
        rssd.ssd_apply(rp, jnp.asarray(x), rcommon.ShardCtx(
            compute_dtype=jnp.float32), rcfg, None, chunk=256)[0]),
        rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_prefill_matches_its_own_stepwise_decode():
    """The state-space duality in the port alone (the reference's test)."""
    tcfg, _, tp, _ = _pair(rssd.ssd_decls, "mamba2-370m", 1, d_model=48,
                           ssm_heads=4, ssm_head_dim=8, ssm_state=16)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 23, 48)) * 0.3).astype(np.float32)
    y_full, cache = tssd.ssd_apply(tp, _t(x), tcommon.ShardCtx(
        compute_dtype=torch.float32, make_cache=True), tcfg, None, chunk=8)
    state = {"state": torch.zeros_like(cache["state"]),
             "conv_tail": torch.zeros_like(cache["conv_tail"])}
    ctx = tcommon.ShardCtx(compute_dtype=torch.float32)
    ys = [tssd.ssd_decode(tp, _t(x[:, t:t + 1]), state, ctx, tcfg, None)[0]
          for t in range(23)]
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(cache["state"].numpy(),
                               state["state"].numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)


@pytest.mark.parametrize("s", [1, 17, 64])
def test_rglru_apply_and_decode(s):
    tcfg, rcfg, tp, rp = _pair(rrglru.rglru_decls, "recurrentgemma-2b", 1,
                               d_model=32, rglru_width=32)
    rng = np.random.default_rng(s)
    b = 2
    x = (rng.standard_normal((b, s, 32)) * 0.5).astype(np.float32)
    ry, rc = rrglru.rglru_apply(rp, jnp.asarray(x), rcommon.ShardCtx(
        compute_dtype=jnp.float32, make_cache=True), rcfg, None)
    ty, tc = trglru.rglru_apply(tp, _t(x), tcommon.ShardCtx(
        compute_dtype=torch.float32, make_cache=True), tcfg, None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=RG_RTOL,
                               atol=RG_ATOL)
    np.testing.assert_allclose(tc["h"].numpy(), np.asarray(rc["h"]),
                               rtol=RG_RTOL, atol=RG_ATOL)
    assert tc["h"].dtype == torch.float32
    ctx = tcommon.ShardCtx(compute_dtype=torch.float32)
    rctx = rcommon.ShardCtx(compute_dtype=jnp.float32)
    for _ in range(3):
        xs = (rng.standard_normal((b, 1, 32)) * 0.5).astype(np.float32)
        ry, rc = rrglru.rglru_decode(rp, jnp.asarray(xs), rc, rctx, rcfg,
                                     None)
        ty, tc = trglru.rglru_decode(tp, _t(xs), tc, ctx, tcfg, None)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=RG_RTOL,
                                   atol=RG_ATOL)
    np.testing.assert_allclose(tc["h"].numpy(), np.asarray(rc["h"]),
                               rtol=RG_RTOL, atol=RG_ATOL)


def test_linear_scan_is_the_associative_scan():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (3, 40, 8)).astype(np.float32)
    b = rng.standard_normal((3, 40, 8)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = trglru.linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RG_RTOL,
                               atol=RG_ATOL)

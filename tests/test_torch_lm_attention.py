"""The port's attention and MLA against `repro` on the same inputs.

`chunked_attention` over the parameter grid of ``tests/test_attention.py``
(window, softcap, triangular, KV heads) and against its naive float64
reference; the ring cache at absolute positions; the attention block's
prefill and `attn_decode` over several steps (ring and global caches);
MLA's expanded prefill and absorbed decode against the latent cache.
Float32, tolerance of the reference's own test: rtol 2e-4, atol 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.nn import attention as rattn
from repro.nn import common as rcommon
from repro.nn import mla as rmla
from repro_torch.configs import get_config as tget
from repro_torch.nn import attention as tattn
from repro_torch.nn import common as tcommon
from repro_torch.nn import mla as tmla

RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def naive(q, k, v, q_pos, kv_pos, scale, window=0, softcap=None):
    """``tests/test_attention.py``'s float64 reference."""
    b, sq, h, d = q.shape
    _, skv, hkv, dv = v.shape
    g = h // hkv
    kf = np.repeat(np.asarray(k), g, axis=2)
    vf = np.repeat(np.asarray(v), g, axis=2)
    s = np.einsum("bqhd,bchd->bhqc", np.asarray(q, np.float64),
                  kf.astype(np.float64)) * scale
    if softcap:
        s = softcap * np.tanh(s / softcap)
    qp = np.asarray(q_pos)[:, None, :, None]
    kp = np.asarray(kv_pos)[:, None, None, :]
    ok = (kp <= qp) & (kp >= 0)
    if window > 0:
        ok &= qp - kp < window
    s = np.where(ok, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = np.where(ok, p, 0.0)
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    return np.einsum("bhqc,bchv->bqhv", p, vf.astype(np.float64))


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_self_attention_variants(window, softcap, triangular, hkv):
    rng = np.random.default_rng(window * 31 + hkv)
    b, s, h, d = 2, 32, 4, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    pos = pos.copy()
    pos[1, :3] = -1  # voided slots (a shorter prompt)
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap, kv_chunk=8,
              triangular=triangular)
    port = tattn.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), **kw)
    ref = rattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos),
                                  jnp.asarray(pos), **kw)
    _close(port, ref)
    # a query at position −1 attends to nothing: zeros in all three
    _close(port, naive(q, k, v, pos, pos, d ** -0.5, window, softcap))


def test_ring_cache_masks_by_absolute_position():
    """A rotated ring cache attends as a fresh one; slots hold pos % w."""
    rng = np.random.default_rng(0)
    b, s, hkv, d, w = 2, 12, 1, 4, 8
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    cache = tattn.build_kv_cache(_t(k), _t(v), _t(pos), cache_len=64,
                                 window=w)
    rcache = rattn.build_kv_cache(jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), cache_len=64, window=w)
    for name in ("k", "v", "pos"):
        assert np.array_equal(cache[name].numpy(), np.asarray(rcache[name]))
    kept = np.sort(cache["pos"][0].numpy())
    assert np.array_equal(kept, np.arange(s - w, s))
    assert tuple(cache["k"].shape) == (b, hkv, w, d)
    q = rng.standard_normal((b, 1, 2, d)).astype(np.float32)
    qp = np.full((b, 1), s - 1, np.int32)
    out = tattn.chunked_attention(_t(q), cache["k"], cache["v"], _t(qp),
                                  cache["pos"], scale=0.5, window=w,
                                  kv_chunk=8, kv_layout="bhsd")
    _close(out, naive(q, k, v, qp, pos, 0.5, window=w))


def _attn_pair(cfg, seed):
    rng = np.random.default_rng(seed)
    decls = rattn.attn_decls(cfg)
    p = {k: (rng.standard_normal(d.shape) * 0.3).astype(np.float32)
         for k, d in decls.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("arch,window,cache_len", [
    ("qwen2.5-3b", 0, 24),       # QKV bias, global cache
    ("gemma2-27b", 8, 24),       # softcap, query scale, ring of 8
    ("mixtral-8x22b", 64, 16),   # window beyond the cache: a ring of 16
])
def test_attention_block_prefill_and_decode(arch, window, cache_len):
    """`attn_apply` with a cache, then 5 `attn_decode` steps (the ring
    wraps), outputs and caches against the reference's."""
    cfg = tget(arch).reduced(d_model=32, n_heads=4, head_dim=8)
    rp, tp = _attn_pair(cfg, 7)
    meta = tattn.AttnMeta(window=window)
    rng = np.random.default_rng(8)
    b, s = 2, 11
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    rctx = rcommon.ShardCtx(positions=jnp.asarray(pos), make_cache=True,
                            cache_len=cache_len, compute_dtype=jnp.float32)
    tctx = tcommon.ShardCtx(positions=_t(pos), make_cache=True,
                            cache_len=cache_len, compute_dtype=torch.float32)
    ry, rc = rattn.attn_apply(rp, jnp.asarray(x), rctx, cfg,
                              rattn.AttnMeta(window=window))
    ty, tc = tattn.attn_apply(tp, _t(x), tctx, cfg, meta)
    _close(ty, ry)
    for step in range(5):
        xs = rng.standard_normal((b, 1, 32)).astype(np.float32)
        p1 = np.full((b, 1), s + step, np.int32)
        ry, rc = rattn.attn_decode(
            rp, jnp.asarray(xs), rc,
            rcommon.ShardCtx(positions=jnp.asarray(p1),
                             compute_dtype=jnp.float32),
            cfg, rattn.AttnMeta(window=window))
        ty, tc = tattn.attn_decode(
            tp, _t(xs), tc,
            tcommon.ShardCtx(positions=_t(p1), compute_dtype=torch.float32),
            cfg, meta)
        _close(ty, ry)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
    _close(tc["k"], rc["k"])
    _close(tc["v"], rc["v"])


def test_mla_apply_and_absorbed_decode():
    cfg = dataclasses.replace(tget("deepseek-v3-671b").reduced(),
                              compute_dtype="float32")
    rcfg = dataclasses.replace(rget("deepseek-v3-671b").reduced(),
                               compute_dtype="float32")
    decls = rmla.mla_decls(rcfg)
    rp = rcommon.init_params(decls, jax.random.key(3))
    from torch_differential import ref_param_arrays

    tp = tcommon.unflatten_tree({k: _t(v) for k, v in
                                 ref_param_arrays(rp).items()})
    rng = np.random.default_rng(4)
    b, s, cache_len = 2, 9, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    ry, rc = rmla.mla_apply(rp, jnp.asarray(x), rcommon.ShardCtx(
        positions=jnp.asarray(pos), make_cache=True, cache_len=cache_len,
        compute_dtype=jnp.float32), rcfg, None)
    ty, tc = tmla.mla_apply(tp, _t(x), tcommon.ShardCtx(
        positions=_t(pos), make_cache=True, cache_len=cache_len,
        compute_dtype=torch.float32), cfg, None)
    _close(ty, ry)
    for step in range(4):
        xs = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((b, 1), s + step, np.int32)
        ry, rc = rmla.mla_decode(rp, jnp.asarray(xs), rc, rcommon.ShardCtx(
            positions=jnp.asarray(p1), compute_dtype=jnp.float32), rcfg, None)
        ty, tc = tmla.mla_decode(tp, _t(xs), tc, tcommon.ShardCtx(
            positions=_t(p1), compute_dtype=torch.float32), cfg, None)
        _close(ty, ry)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
    _close(tc["c_kv"], rc["c_kv"])
    _close(tc["k_rope"], rc["k_rope"])

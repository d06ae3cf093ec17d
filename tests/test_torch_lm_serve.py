"""The port's language-model serving against `repro`'s: the default
bf16 engine and CSD-P quantized serving.

* bf16 (the configs' default compute dtype): prefill logits within 5%
  of the logits' scale of `repro`'s (two bf16 evaluations of one model;
  measured 0.7–2.3% on these archs), greedy-token agreement reported;
* `quantize_param_tree` over the converted tree quantizes the same
  leaves as `repro`'s, with the same count and the same values, and the
  quantized engine's tokens equal `repro`'s fake-quantized engine's at
  float32;
* the three cases of ``tests/test_serve_quant.py``, each held against
  its `repro` counterpart.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.serve_quant import quantize_param_tree as r_quantize
from repro.serving import ServeEngine as RServe
from repro_torch.configs import get_config
from repro_torch.core.serve_quant import quantize_param_tree
from repro_torch.nn import flatten_tree
from repro_torch.serving import ServeEngine
from torch_differential import ref_config, ref_lm_params, ref_param_arrays

BF16_REL = 0.05


def _tokens_cfg(arch, **over):
    cfg = get_config(arch).reduced(**over)
    if cfg.input_kind == "embeds":
        cfg = dataclasses.replace(cfg, input_kind="tokens")
    return cfg


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-370m",
                                  "qwen2.5-3b", "recurrentgemma-2b"])
def test_default_bf16_engine_is_near_the_references(arch, record_property):
    cfg = _tokens_cfg(arch)
    assert cfg.compute_dtype == "bfloat16"
    rparams, tparams = ref_lm_params(cfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    reng = RServe(ref_config(cfg), rparams, cache_len=64)
    teng = ServeEngine(cfg, tparams, cache_len=64, device="cpu")
    rlog, _ = reng._prefill(rparams, {"tokens": jnp.asarray(prompts)})
    tlog, _ = teng.prefill(prompts)
    rlog = np.asarray(rlog)
    assert tlog.dtype == torch.float32
    rel = float(np.abs(tlog.numpy() - rlog).max() / np.abs(rlog).max())
    assert rel <= BF16_REL, rel
    agree = float((teng.generate(prompts, 8).numpy()
                   == np.asarray(reng.generate(prompts, 8))).mean())
    record_property("bf16_prefill_rel", rel)
    record_property("bf16_greedy_token_agreement", agree)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2.5-3b",
                                  "recurrentgemma-2b"])
def test_quantized_tree_and_engine_equal_the_references(arch):
    cfg = dataclasses.replace(_tokens_cfg(arch, vocab_size=256),
                              compute_dtype="float32")
    rparams, tparams = ref_lm_params(cfg, seed=1)
    rq, rstats = r_quantize(rparams, 4)
    tq, tstats = quantize_param_tree(flatten_tree(tparams), 4, device="cpu")
    assert tstats == pytest.approx(rstats, rel=1e-12)
    assert tstats["n_quantized"] > 0
    want = ref_param_arrays(rq)
    before = ref_param_arrays(rparams)
    assert set(tq) == set(want)
    changed = {k for k in want if not np.array_equal(want[k], before[k])}
    assert {k for k in tq if not np.array_equal(tq[k].numpy(), before[k])} \
        == changed
    assert len(changed) == tstats["n_quantized"]
    for k in tq:
        assert np.array_equal(tq[k].numpy(), want[k]), k
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    got = ServeEngine(cfg, tq, cache_len=32, device="cpu").generate(
        prompts, 6)
    ref = RServe(ref_config(cfg), rq, cache_len=32).generate(prompts, 6)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def _qwen_small(compute_dtype="bfloat16"):
    return dataclasses.replace(
        get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=256),
        compute_dtype=compute_dtype)


def test_error_decreases_and_engine_runs():
    cfg = _qwen_small()
    rparams, tparams = ref_lm_params(cfg)
    flat = flatten_tree(tparams)
    errs = {}
    for p in (1, 2, 4):
        qparams, stats = quantize_param_tree(flat, p, device="cpu")
        _, rstats = r_quantize(rparams, p)
        assert stats["n_quantized"] > 0
        assert stats == pytest.approx(rstats, rel=1e-12)
        errs[p] = stats["mean_rel_err"]
    assert errs[1] > errs[2] > errs[4]
    assert errs[4] < 0.01
    eng = ServeEngine(cfg, qparams, cache_len=64, device="cpu")
    out = eng.generate(np.zeros((2, 8), np.int32), max_new_tokens=4)
    assert tuple(out.shape) == (2, 4)


def test_generate_zero_new_tokens_is_empty():
    cfg = _qwen_small()
    rparams, tparams = ref_lm_params(cfg)
    eng = ServeEngine(cfg, tparams, cache_len=64, device="cpu")
    prompts = np.zeros((3, 8), np.int32)
    out = eng.generate(prompts, max_new_tokens=0)
    ref = np.asarray(RServe(ref_config(cfg), rparams, 64).generate(
        prompts, max_new_tokens=0))
    assert tuple(out.shape) == ref.shape == (3, 0)
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    toks, steps = eng.generate(prompts, 0, with_logits=True)
    assert tuple(toks.shape) == (3, 0) and steps == []
    assert tuple(eng.generate(prompts, max_new_tokens=1).shape) == (3, 1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_greedy_tokens_mostly_stable_at_p4(compute_dtype):
    """`repro`'s criterion (agreement > 0.7) on the port; at float32 the
    base and the quantized tokens also equal `repro`'s."""
    cfg = _qwen_small(compute_dtype)
    rparams, tparams = ref_lm_params(cfg, seed=1)
    prompts = np.random.default_rng(0).integers(0, 256, (4, 16)) \
        .astype(np.int32)
    base = ServeEngine(cfg, tparams, 64, device="cpu").generate(prompts, 8)
    qp, _ = quantize_param_tree(flatten_tree(tparams), 4, device="cpu")
    quant = ServeEngine(cfg, qp, 64, device="cpu").generate(prompts, 8)
    assert float((base == quant).float().mean()) > 0.7
    if compute_dtype == "float32":
        rq, _ = r_quantize(rparams, 4)
        rcfg = ref_config(cfg)
        assert np.array_equal(base.numpy(), np.asarray(
            RServe(rcfg, rparams, 64).generate(prompts, 8)))
        assert np.array_equal(quant.numpy(), np.asarray(
            RServe(rcfg, rq, 64).generate(prompts, 8)))


def test_prefill_lengths_void_cache_positions():
    """Attention archs take prompts of several lengths: positions past a
    prompt's length are −1 in the cache and masked, as in `repro`."""
    from repro.serving.engine import make_prefill_fn as r_prefill_fn
    from repro_torch.serving import make_decode_fn, make_prefill_fn

    cfg = dataclasses.replace(_qwen_small(), compute_dtype="float32")
    rparams, tparams = ref_lm_params(cfg)
    tok = np.random.default_rng(3).integers(0, 256, (3, 10)).astype(np.int32)
    lengths = np.array([10, 6, 3], np.int32)
    rlog, rstate = r_prefill_fn(ref_config(cfg), 16)(
        rparams, {"tokens": jnp.asarray(tok), "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        tlog, tstate = make_prefill_fn(cfg, 16)(
            tparams, {"tokens": torch.tensor(tok),
                      "lengths": torch.tensor(lengths)})
    assert np.array_equal(tstate["pos"].numpy(), lengths)
    cpos = tstate["caches"][0][0]["pos"].clone().numpy()
    assert np.array_equal(cpos, np.asarray(rstate["caches"][0][0]["pos"]))
    assert (cpos[:, 2, 3:] == -1).all() and (cpos[:, 2, :3] >= 0).all()
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), rtol=2e-4,
                               atol=2e-5)
    # the next token of each prompt goes to its own length's slot (the
    # cache is written in place)
    with torch.inference_mode():
        nxt, _ = make_decode_fn(cfg)(
            tparams, {"token": torch.tensor(tok[:, :1])}, tstate)
    assert tuple(nxt.shape) == (3, 1, 256)
    after = tstate["caches"][0][0]["pos"].numpy()
    changed = np.argwhere(after != cpos)
    assert sorted(map(tuple, changed[:, 1:])) == [(0, 10), (0, 10), (1, 6),
                                                  (1, 6), (2, 3), (2, 3)]

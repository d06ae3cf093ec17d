"""`ServeEngine` on a mesh of CPU slots, every arch reduced, float32.

For each arch (an embeds backbone served on tokens, as the launchers
serve it), a (2, 4) mesh in both decode cases of `make_rules` — the
batch over ``data`` with the caches' sequence over ``model``, and a
global batch below the data size (the batch unsplit, the sequence over
``(data, model)``) — generates greedily from the same parameters as the
unsharded engine and as `repro`'s engine: the tokens must be equal, and
every emitted token's float32 logits within 1e-4 of their scale of both
(the mesh attends its cache pieces apart and merges them by log-sum-exp,
so the sums run in another order: not 0).  Attention caches split over
``cache_seq`` must open as per-piece views (sequence-parallel decode).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_differential import ref_config, ref_lm_params

from repro_torch.configs import all_configs, get_config
from repro_torch.distributed import (ShardedTensor, gather, make_mesh,
                                     make_rules)
from repro_torch.nn import flatten_tree
from repro_torch.serving import ServeEngine

BOUND = 1e-4
BATCH, PROMPT, CACHE, NEW = 4, 12, 32, 5
SAME = ["cpu"] * 8
DISTINCT = [f"cpu:{i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32", input_kind="tokens")
    return dataclasses.replace(cfg, moe_groups=2) if cfg.n_experts else cfg


def _ref_generate(cfg, rparams, prompts):
    """`repro`'s greedy tokens and each emitted token's logits."""
    from repro.serving import ServeEngine as RServe

    reng = RServe(ref_config(cfg), rparams, cache_len=CACHE)
    logits, state = reng._prefill(rparams, {"tokens": jnp.asarray(prompts)})
    steps = [np.asarray(logits[:, -1])]
    toks = [steps[0].argmax(-1).astype(np.int32)]
    for _ in range(NEW - 1):
        logits, state = reng._decode(
            rparams, {"token": jnp.asarray(toks[-1][:, None])}, state)
        steps.append(np.asarray(logits[:, -1]))
        toks.append(steps[-1].argmax(-1).astype(np.int32))
    return np.stack(toks, 1), steps


def _gap(got, want) -> float:
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               / float(np.abs(np.asarray(w)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_mesh_engine_matches_unsharded_and_the_reference(arch):
    cfg = _cfg(arch)
    rparams, tparams = ref_lm_params(cfg, seed=0)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    rtok, rlog = _ref_generate(cfg, rparams, prompts)
    plain = ServeEngine(cfg, tparams, cache_len=CACHE, device="cpu")
    ptok, plog = plain.generate(prompts, NEW, with_logits=True)
    assert np.array_equal(ptok.numpy(), rtok)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    for gb in (None, 1):  # batch over data; a batch below the data size
        rules = make_rules(mesh, "decode", gb)
        eng = ServeEngine(cfg, tparams, cache_len=CACHE, mesh=mesh,
                          rules=rules)
        assert all(isinstance(x, ShardedTensor)
                   for x in flatten_tree(eng.params).values())
        tok, log = eng.generate(prompts, NEW, with_logits=True)
        assert torch.equal(tok, ptok), (gb, tok, ptok)
        assert _gap(log, plog) <= BOUND, gb
        assert _gap(log, rlog) <= BOUND, gb


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b",
                                  "recurrentgemma-2b"])
def test_mesh_engine_on_distinct_slot_devices(arch):
    """Slots on eight distinct devices: replicated weights and caches
    have a piece a device, and decode still equals the unsharded one."""
    cfg = _cfg(arch)
    _, tparams = ref_lm_params(cfg, seed=0)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    ptok, plog = ServeEngine(cfg, tparams, cache_len=CACHE,
                             device="cpu").generate(prompts, NEW,
                                                    with_logits=True)
    mesh = make_mesh((2, 4), ("data", "model"), devices=DISTINCT)
    for gb in (None, 1):
        eng = ServeEngine(cfg, tparams, cache_len=CACHE, mesh=mesh,
                          rules=make_rules(mesh, "decode", gb))
        tok, log = eng.generate(prompts, NEW, with_logits=True)
        assert torch.equal(tok, ptok) and _gap(log, plog) <= BOUND


@pytest.mark.parametrize("gb,pieces", [(None, 4), (1, 8)])
def test_attention_caches_are_attended_piece_by_piece(gb, pieces,
                                                      monkeypatch):
    """In decode rules the attention cache's ring is split over
    ``model`` (or ``(data, model)``), and every attention layer decodes
    against `SeqShards` views of its pieces; the prefill's cache
    gathered equals the unsharded engine's (its values to BOUND: the
    mesh's k projection is row-parallel)."""
    import repro_torch.distributed.placement as pl

    cfg = _cfg("qwen2.5-3b")
    _, tparams = ref_lm_params(cfg, seed=0)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    eng = ServeEngine(cfg, tparams, cache_len=CACHE, mesh=mesh,
                      rules=make_rules(mesh, "decode", gb))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(0))
    _, state = eng.prefill(prompts)
    _, pstate = ServeEngine(cfg, tparams, cache_len=CACHE,
                            device="cpu").prefill(prompts)
    k = state["caches"][0][0]["k"]
    assert len(k.groups()) == pieces * (2 if gb is None else 1)
    # the mesh projects k row-parallel over ``model`` (wk's d_model cut:
    # its 2 kv heads do not split 4 ways), so its sums run in another
    # order than the unsharded engine's: the filled slots where they
    # are, the values within BOUND of their scale, the positions exact
    got, want = gather(k, "cpu"), pstate["caches"][0][0]["k"]
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= BOUND * float(want.abs().max())
    assert torch.equal(gather(state["caches"][0][0]["pos"], "cpu"),
                       pstate["caches"][0][0]["pos"])
    kinds = []
    real = pl.open_cache

    def spy(tree, ctx, *dims):
        view, close = real(tree, ctx, *dims)
        kinds.append(type(view["k"]).__name__)
        return view, close

    monkeypatch.setattr(pl, "open_cache", spy)
    eng.decode(torch.zeros(BATCH, dtype=torch.int32), state)
    n_slots = 2 if gb is None else 1
    assert kinds == ["SeqShards"] * cfg.n_layers * n_slots

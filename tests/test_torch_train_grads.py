"""The port's gradients against `repro`'s: every arch reduced, float32.

One converted parameter tree (`ref_lm_params`) and one batch go through
`jax.value_and_grad` of `repro`'s `loss_fn` and through the port's
`make_grad_fn` (backward of its `loss_fn`, each layer's gradient written
into the step's buffer).  Per leaf, max |Δg| ≤ 1e-4 of max |g_ref|; the
loss and its metrics within the LM tests' rtol 2e-4 / atol 2e-5.  Remat
recomputes and changes nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_differential import (lm_train_batch, ref_config, ref_lm_params,
                                ref_param_arrays, train_tree_gap)

ARCHS = ("deepseek-coder-33b", "deepseek-v3-671b", "gemma2-27b",
         "internvl2-76b", "mamba2-370m", "mixtral-8x22b", "musicgen-large",
         "qwen2.5-3b", "recurrentgemma-2b", "starcoder2-3b")
GRAD_REL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
ROWS, SEQ = 2, 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models on one thread: beside the other test workers, a pool of
    spinning OpenMP threads a process slows them by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32", **kw)


def _ref_value_and_grad(cfg, rparams, batch):
    from repro.nn import ShardCtx as RCtx
    from repro.nn import loss_fn as r_loss
    from repro.training import make_positions

    def f(p, b):
        return r_loss(p, b, ref_config(cfg), RCtx(
            positions=make_positions(b), compute_dtype=jnp.float32))

    (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_grads(cfg, tparams, batch):
    from repro_torch.nn import flatten_tree
    from repro_torch.training import TrainHParams
    from repro_torch.training.train_step import make_grad_fn

    loss, metrics, grads = make_grad_fn(cfg, TrainHParams())(
        tparams, {k: torch.tensor(v) for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flatten_tree(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_the_reference(arch):
    cfg = _cfg(arch)
    rparams, tparams = ref_lm_params(cfg, seed=0)
    batch = lm_train_batch(cfg, ROWS, SEQ, seed=1)
    rloss, rmet, rgrads = _ref_value_and_grad(cfg, rparams, batch)
    tloss, tmet, tgrads = _port_grads(cfg, tparams, batch)
    np.testing.assert_allclose(tloss, rloss, rtol=RTOL, atol=ATOL)
    assert set(tmet) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(tmet[k], rmet[k], rtol=RTOL, atol=ATOL)
    ref = ref_param_arrays(rgrads)
    assert set(tgrads) == set(ref)
    assert all(tgrads[k].dtype == torch.float32 for k in ref)
    gap = train_tree_gap(tgrads, ref, GRAD_REL)
    assert gap["worst"] <= GRAD_REL, gap


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_remat_recomputes_without_changing_values(arch):
    """``remat="full"`` (every published config's) checkpoints each
    repeat unit; its loss and gradients equal ``remat="none"``'s."""
    on = _cfg(arch, remat="full")
    off = _cfg(arch, remat="none")
    assert on.scan_layers
    _, tparams = ref_lm_params(on, seed=0)
    batch = lm_train_batch(on, ROWS, SEQ, seed=2)
    l_on, m_on, g_on = _port_grads(on, tparams, batch)
    l_off, m_off, g_off = _port_grads(off, tparams, batch)
    assert l_on == l_off and m_on == m_off
    for k in g_off:
        torch.testing.assert_close(g_on[k], g_off[k], rtol=1e-6, atol=0)


def test_remat_checkpoints_each_repeat_unit(monkeypatch):
    """With gradients on, `forward` hands every repeat unit to
    `torch.utils.checkpoint` (and no unit without them)."""
    from repro_torch.nn import ShardCtx, loss_fn, model
    from repro_torch.nn.model import stage_plan

    calls = []
    real = model.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(model, "checkpoint", spy)
    cfg = _cfg("recurrentgemma-2b", remat="full")
    _, tparams = ref_lm_params(cfg, seed=0)
    batch = {k: torch.tensor(v) for k, v in
             lm_train_batch(cfg, ROWS, SEQ, seed=3).items()}
    ctx = ShardCtx(positions=torch.arange(SEQ)[None].expand(ROWS, SEQ),
                   compute_dtype=torch.float32)
    with torch.no_grad():
        loss_fn(tparams, batch, cfg, ctx)
    assert calls == []
    loss_fn(tparams, batch, cfg, ctx)
    assert calls == [False] * sum(st.repeat for st in stage_plan(cfg))

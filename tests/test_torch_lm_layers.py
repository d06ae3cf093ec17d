"""The port's language-model configs and shared layers against `repro`.

`repro_torch.configs` must be the reference's registry field for field
(full and reduced configs, shape cells, input specs), the parameter
counts of every full config equal to the reference's as exact integers
without allocating a weight, and each layer of `repro_torch.nn.layers`
(norms, rope, sinusoids, the three MLPs, embed and unembed with
softcap) equal to `repro.nn.layers` on the same float32 inputs and
parameters, within the reference attention test's tolerance
(rtol 2e-4, atol 2e-5, ``tests/test_attention.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.nn import common as rcommon
from repro.nn import layers as rlayers
from repro.nn.model import model_decls as r_model_decls
from repro_torch import configs as tconfigs
from repro_torch.nn import common as tcommon
from repro_torch.nn import layers as tlayers
from repro_torch.nn.model import model_decls as t_model_decls

ARCHS = sorted(rconfigs.all_configs())
RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_registry_is_the_references():
    assert sorted(tconfigs.all_configs()) == ARCHS
    assert tconfigs.LONG_CONTEXT_ARCHS == rconfigs.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    assert dataclasses.asdict(tconfigs.FirConfig()) \
        == dataclasses.asdict(rconfigs.FirConfig())
    for arch in ARCHS:
        assert tconfigs.cells_for(arch) == rconfigs.cells_for(arch)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_equal_the_references(arch):
    """Full and reduced configs field for field; `count_params` and
    `count_active_params` of the full config exact, from declarations
    only; the input specs' shapes and dtypes for every shape cell."""
    full_t, full_r = tconfigs.get_config(arch), rconfigs.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_r)
    assert dataclasses.asdict(full_t.reduced()) \
        == dataclasses.asdict(full_r.reduced())
    assert dataclasses.asdict(full_t.reduced(n_layers=3, d_model=64)) \
        == dataclasses.asdict(full_r.reduced(n_layers=3, d_model=64))
    assert full_t.head_dim_ == full_r.head_dim_
    dt, dr = t_model_decls(full_t), r_model_decls(full_r)
    assert tcommon.count_params(dt) == rcommon.count_params(dr)
    k, e = full_t.experts_per_token, full_t.n_experts
    assert tcommon.count_active_params(dt, k, e) \
        == rcommon.count_active_params(dr, k, e)
    meta = tcommon.abstract_params(dt)
    flat = tcommon.flatten_tree(meta)
    assert all(t.device.type == "meta" for t in flat.values())
    assert sum(t.numel() for t in flat.values()) == tcommon.count_params(dt)
    for shape in rconfigs.SHAPES.values():
        ts = tconfigs.input_specs(full_t, tconfigs.SHAPES[shape.name])
        rs = rconfigs.input_specs(full_r, shape)
        assert {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for n, t in ts.items()} \
            == {n: (tuple(s.shape), str(s.dtype)) for n, s in rs.items()}
        assert all(t.device.type == "meta" for t in ts.values())


def test_init_params_draws_the_reference_distributions():
    cfg = tconfigs.get_config("qwen2.5-3b").reduced()
    decls = t_model_decls(cfg)
    p = tcommon.init_params(decls, torch.Generator().manual_seed(0),
                            device="cpu")
    flat, want = tcommon.flatten_tree(p), tcommon.flatten_tree(decls)
    assert list(flat) == list(want)
    for name, d in want.items():
        t = flat[name]
        assert tuple(t.shape) == d.shape and t.dtype == torch.float32
        if d.init == "zeros":
            assert not t.any()
        elif d.init == "ones":
            assert (t == 1).all()
        else:  # fan-in normal: std 1/sqrt(shape[fan_axis])
            std = float(t.std())
            assert abs(std * np.sqrt(d.shape[d.fan_axis]) - 1) < 0.1, name
    again = tcommon.init_params(decls, torch.Generator().manual_seed(0),
                                device="cpu")
    assert all(torch.equal(flat[n], t)
               for n, t in tcommon.flatten_tree(again).items())


@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_unit", "layernorm"])
def test_norms(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    p = {k: rng.standard_normal(48).astype(np.float32)
         for k in rlayers.norm_decls(48, kind)}
    ref = rlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind)
    port = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(port, ref)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_and_sinusoidal(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(-1, 4000, (2, 7)).astype(np.int32)
    _close(tlayers.rope(_t(x), _t(pos), theta),
           rlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(tlayers.sinusoidal(_t(pos), 32),
           rlayers.sinusoidal(jnp.asarray(pos), 32))


@pytest.mark.parametrize("kind,bias", [("swiglu", False), ("geglu", False),
                                       ("gelu", False), ("gelu", True)])
def test_mlps(kind, bias):
    rng = np.random.default_rng(2)
    decls = rlayers.mlp_decls(32, 64, kind, bias)
    p = {k: (rng.standard_normal(d.shape) * 0.2).astype(np.float32)
         for k, d in decls.items()}
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    ref = rlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), kind,
                            rcommon.ShardCtx(compute_dtype=jnp.float32))
    port = tlayers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), kind,
                             tcommon.ShardCtx(compute_dtype=torch.float32))
    _close(port, ref)


@pytest.mark.parametrize("scale_by_sqrt_d", [False, True])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_embed_and_unembed(scale_by_sqrt_d, softcap):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 50)).astype(np.float32) * 4
    tok = rng.integers(0, 50, (2, 9)).astype(np.int32)
    rctx = rcommon.ShardCtx(compute_dtype=jnp.float32)
    tctx = tcommon.ShardCtx(compute_dtype=torch.float32)
    rx = rlayers.embed_lookup({"table": jnp.asarray(table)}, jnp.asarray(tok),
                              rctx, scale_by_sqrt_d)
    tx = tlayers.embed_lookup({"table": _t(table)}, _t(tok), tctx,
                              scale_by_sqrt_d)
    _close(tx, rx)
    for tied in (False, True):
        ref = rlayers.unembed({"kernel": jnp.asarray(kernel)}, rx, rctx,
                              jnp.asarray(table) if tied else None, softcap)
        port = tlayers.unembed({"kernel": _t(kernel)}, tx, tctx,
                               _t(table) if tied else None, softcap)
        assert port.dtype == torch.float32
        _close(port, ref)


def test_flatten_names_are_the_references_key_paths():
    from torch_differential import ref_param_arrays

    cfg = tconfigs.get_config("recurrentgemma-2b").reduced()
    rp = rcommon.init_params(r_model_decls(rconfigs.get_config(
        "recurrentgemma-2b").reduced()), jax.random.key(0))
    names = tcommon.flatten_tree(t_model_decls(cfg))
    assert list(names) == list(ref_param_arrays(rp))
    tree = tcommon.unflatten_tree(names)
    assert tcommon.flatten_tree(tree) == names


def test_language_model_module_holds_the_tree_under_its_key_paths():
    """`LanguageModel`'s parameter names are the reference's key paths:
    its ``state_dict()`` is the flat tree `quantize_param_tree` takes and
    ``load_state_dict`` takes back; a tree of another shape is refused."""
    from repro_torch.core.serve_quant import quantize_param_tree
    from repro_torch.nn import LanguageModel, forward

    cfg = tconfigs.get_config("mixtral-8x22b").reduced(compute_dtype="float32")
    p = tcommon.init_params(t_model_decls(cfg),
                            torch.Generator().manual_seed(1), device="cpu")
    m = LanguageModel(cfg, p)
    assert list(m.state_dict()) == list(tcommon.flatten_tree(p))
    assert not any(t.requires_grad for t in m.parameters())
    tok = torch.tensor(np.random.default_rng(4).integers(0, 512, (2, 8)),
                       dtype=torch.int32)
    ctx = tcommon.ShardCtx(positions=torch.arange(8)[None].expand(2, 8),
                           compute_dtype=torch.float32)
    assert torch.equal(m({"tokens": tok}, ctx)[0],
                       forward(p, {"tokens": tok}, cfg, ctx)[0])
    q, stats = quantize_param_tree(m.state_dict(), 4, device="cpu")
    assert stats["n_quantized"] > 0
    m.load_state_dict(q)
    assert torch.equal(m({"tokens": tok}, ctx)[0],
                       forward(q, {"tokens": tok}, cfg, ctx)[0])
    bad = dict(tcommon.flatten_tree(p))
    bad["final_norm/scale"] = torch.ones(3)
    with pytest.raises(ValueError, match="final_norm/scale"):
        LanguageModel(cfg, bad)
    del bad["final_norm/scale"]
    with pytest.raises(ValueError, match="missing"):
        LanguageModel(cfg, bad)

"""The port's train step against `repro`'s jitted step, reduced archs in
float32: three steps with a nonzero learning rate, ``grad_accum`` 1 and
2, AdamW (qwen2.5-3b) and Adafactor (deepseek-v3-671b, its own
optimizer).  The metrics within the LM tests' rtol 2e-4 / atol 2e-5;
params and optimizer state within 1e-4 of each leaf's scale.

Adam's ``m / (√v + eps)`` makes an update of order ``lr`` from a
gradient of any size, so an element whose gradient is tiny beside its
leaf's largest passes its rounding on to an ``lr``-sized step (most of
qwen's zero-initialized key bias ``bk``: its median element's first
moment is 9e-4 of its largest, and its scale after three steps is a few
``lr``).  Such elements are counted, and their leaves named, by
`train_tree_gap` (an element beyond the bound whose own m differs by
more than a quarter of the bound of itself or whose v by more than half
— past what keeps its update within half the bound —, and whose
difference is within the most two AdamW runs can part,
`adam_drift_bound`); every other element must hold the bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_differential import (adam_drift_bound, lm_train_batch,
                                ref_config, ref_lm_params, ref_param_arrays,
                                train_tree_gap)

from repro_torch.configs import get_config
from repro_torch.nn import flatten_tree, model_decls
from repro_torch.nn.common import map_tree
from repro_torch.training import (OptHParams, TrainHParams,
                                  abstract_train_state, make_positions,
                                  make_train_step, train_state_init)

STATE_REL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
OPT = OptHParams(learning_rate=1e-3, warmup_steps=1, total_steps=10)
ROWS, SEQ = 4, 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models on one thread: beside the other test workers, a pool of
    spinning OpenMP threads a process slows them by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32", **kw)


def _ref_hp(hp):
    import repro.training as rt

    return rt.TrainHParams(opt=rt.OptHParams(**dataclasses.asdict(hp.opt)),
                           grad_accum=hp.grad_accum)


@pytest.mark.parametrize("arch,grad_accum", [("qwen2.5-3b", 1),
                                             ("qwen2.5-3b", 2),
                                             ("deepseek-v3-671b", 1)])
def test_three_steps_match_the_reference_jitted_step(arch, grad_accum):
    import repro.training as rt

    cfg = _cfg(arch)
    hp = TrainHParams(opt=OPT, grad_accum=grad_accum)
    rparams, tparams = ref_lm_params(cfg, seed=0)
    rstate = rt.train_state_init(rparams, ref_config(cfg))
    rstep = jax.jit(rt.make_train_step(ref_config(cfg), _ref_hp(hp)))
    state = train_state_init(tparams, cfg)
    step = make_train_step(cfg, hp)
    amplified = 0
    for i in range(3):
        batch = lm_train_batch(cfg, ROWS, SEQ, seed=10 + i)
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, {k: torch.tensor(v)
                                  for k, v in batch.items()})
        assert set(met) == set(rmet) == {"xent", "zloss", "aux", "loss",
                                         "grad_norm"}
        for k in rmet:
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=RTOL, atol=ATOL)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        ropt = ref_param_arrays(rstate["opt"])
        gap = train_tree_gap(flatten_tree(state["params"]),
                             ref_param_arrays(rstate["params"]), STATE_REL,
                             opt=(flatten_tree(state["opt"]), ropt),
                             drift=adam_drift_bound(OPT, range(i + 1)))
        assert gap["worst"] <= STATE_REL, gap
        assert set(gap["amplified_leaves"]) <= {"stage0/slot0/mixer/bk"}, gap
        amplified = max(amplified, gap["amplified"])
        ogap = train_tree_gap(flatten_tree(state["opt"]), ropt, STATE_REL)
        assert ogap["worst"] <= STATE_REL, ogap
    # the count is reported, not bounded: it is what the rounding gives
    print(f"{arch} grad_accum={grad_accum}: {amplified} elements outside "
          f"{STATE_REL}, each with moments looser than that of itself")


@pytest.mark.parametrize("leaf,n_off,off,excused", [
    ("ffn/w", 10, 1e-3, True),       # 1% of the leaf, within the drift
    ("ffn/w", 11, 1e-3, False),      # more than 1% of an ordinary leaf
    ("mixer/bk", 500, 1e-3, True),   # a key bias: any share
    ("mixer/bk", 1, 3e-3, False),    # beyond what two runs can part
])
def test_amplified_rounding_is_excused_only_within_its_limits(
        leaf, n_off, off, excused):
    """`train_tree_gap` excuses an element beyond the bound only when its
    own moments are loose, its difference is within ``drift``, and its
    leaf is a key bias or the excused elements are at most 1% of it."""
    rng = np.random.default_rng(0)
    ref = {leaf: rng.uniform(0.5, 1.0, 1000)}
    m = rng.uniform(0.5, 1.0, 1000)
    port = {leaf: torch.tensor(ref[leaf])}
    pm = torch.tensor(m)
    port[leaf][:n_off] += off
    pm[:n_off] *= 1.01  # the moments of exactly those elements are loose
    opt = ({f"m/{leaf}": pm, f"v/{leaf}": torch.tensor(m)},
           {f"m/{leaf}": m, f"v/{leaf}": m})
    gap = train_tree_gap(port, ref, STATE_REL, opt=opt, drift=2e-3)
    assert (gap["worst"] <= STATE_REL) is excused, gap
    assert gap["amplified"] == (n_off if excused else 0), gap


@pytest.mark.parametrize("mom,rel,excused", [
    ("m", 1e-5, False),  # m within a quarter of the bound: tight
    ("m", 5e-5, True),   # beyond it: loose
    ("v", 4e-5, False),  # v within half the bound: tight
    ("v", 8e-5, True),   # beyond it: loose
])
def test_tight_moments_hold_their_params_to_the_bound(mom, rel, excused):
    """An element whose own m agrees within a quarter of the bound and
    whose v within half of it has an update within half the bound of
    itself, so its param gap is held to the bound (the ``worst``
    reading); past either, it is loose and counted within the drift."""
    rng = np.random.default_rng(0)
    leaf = "ffn/w"
    ref = {leaf: rng.uniform(0.5, 1.0, 1000)}
    m = rng.uniform(0.5, 1.0, 1000)
    port = {leaf: torch.tensor(ref[leaf])}
    port[leaf][0] += 1.5e-4  # 1.5e-4 of the leaf's scale, at most
    moms = {"m": torch.tensor(m), "v": torch.tensor(m)}
    moms[mom][0] *= 1 + rel
    opt = ({f"m/{leaf}": moms["m"], f"v/{leaf}": moms["v"]},
           {f"m/{leaf}": m, f"v/{leaf}": m})
    gap = train_tree_gap(port, ref, STATE_REL, opt=opt, drift=2e-3)
    assert (gap["worst"] <= STATE_REL) is excused, gap
    assert (gap["loose_worst"] > STATE_REL) is excused, gap
    assert gap["amplified_by_leaf"] == ({leaf: (1, 1e-3)} if excused
                                        else {}), gap


def test_the_step_updates_the_state_in_place():
    cfg = _cfg("qwen2.5-3b", n_layers=2)
    _, tparams = ref_lm_params(cfg, seed=0)
    state = train_state_init(tparams, cfg)
    ptrs = {k: t.data_ptr() for k, t in flatten_tree(
        {"p": state["params"], "o": state["opt"]}).items()}
    new, _ = make_train_step(cfg, TrainHParams(opt=OPT))(
        state, {k: torch.tensor(v) for k, v in
                lm_train_batch(cfg, 2, 8, seed=0).items()})
    assert new["params"] is state["params"] and new["opt"] is state["opt"]
    assert ptrs == {k: t.data_ptr() for k, t in flatten_tree(
        {"p": new["params"], "o": new["opt"]}).items()}
    assert int(new["step"]) == 1 and int(state["step"]) == 0


def test_bf16_params_accumulate_microbatch_grads_in_float32():
    """As the reference sums microbatches into float32 zeros, the port's
    accumulated grads are float32 for bfloat16 params, and the step
    keeps the params bfloat16."""
    from repro_torch.training.train_step import make_grad_fn

    cfg = _cfg("qwen2.5-3b", n_layers=2)
    _, tparams = ref_lm_params(cfg, seed=0)
    bf = map_tree(lambda t: t.to(torch.bfloat16), tparams)
    batch = {k: torch.tensor(v) for k, v in
             lm_train_batch(cfg, 4, 8, seed=1).items()}
    for accum, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        _, _, grads = make_grad_fn(cfg, TrainHParams(grad_accum=accum))(
            bf, batch)
        assert {g.dtype for g in flatten_tree(grads).values()} == {dtype}
    state = train_state_init(bf, cfg)
    make_train_step(cfg, TrainHParams(opt=OPT, grad_accum=2))(state, batch)
    assert {p.dtype for p in flatten_tree(state["params"]).values()} \
        == {torch.bfloat16}


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_z_loss_weight_is_the_hparam(z_loss):
    """``TrainHParams.z_loss`` weights the z-loss term: its metric scales
    with it (none at 0, where the loss is the cross-entropy plus the MoE
    aux term), and the gradient moves with it."""
    from repro_torch.training.train_step import make_grad_fn

    cfg = _cfg("qwen2.5-3b", n_layers=2)
    _, tparams = ref_lm_params(cfg, seed=0)
    batch = {k: torch.tensor(v) for k, v in
             lm_train_batch(cfg, 2, 8, seed=2).items()}
    loss0, met0, g0 = make_grad_fn(cfg, TrainHParams())(tparams, batch)
    loss, met, g = make_grad_fn(cfg, TrainHParams(z_loss=z_loss))(tparams,
                                                                  batch)
    assert float(met0["zloss"]) > 0
    assert float(met["zloss"]) == pytest.approx(
        float(met0["zloss"]) * z_loss / 1e-4, rel=1e-6)
    assert float(met["xent"]) == float(met0["xent"])
    assert float(loss) == pytest.approx(
        float(met["xent"]) + float(met["zloss"])
        + cfg.aux_loss_coef * float(met["aux"]), rel=1e-6)
    # the z-loss reaches the logits' table (qwen ties it to the embedding)
    assert not torch.equal(g["embed"]["table"], g0["embed"]["table"])


def test_grad_accum_needs_an_even_split():
    from repro_torch.training.train_step import make_grad_fn

    cfg = _cfg("qwen2.5-3b", n_layers=2)
    _, tparams = ref_lm_params(cfg, seed=0)
    batch = {k: torch.tensor(v) for k, v in
             lm_train_batch(cfg, 3, 8, seed=1).items()}
    with pytest.raises(ValueError, match="microbatches"):
        make_grad_fn(cfg, TrainHParams(grad_accum=2))(tparams, batch)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_abstract_train_state_matches_the_reference(arch):
    """``meta`` tensors with the reference's shapes, dtypes and names
    (params in ``param_dtype``: bfloat16 for deepseek-v3's published
    config; Adafactor's factored state), allocating nothing."""
    from repro.nn import model_decls as r_decls
    from repro.training.train_step import abstract_train_state as r_abstract

    cfg = get_config(arch)
    got = flatten_tree(abstract_train_state(cfg, model_decls(cfg)))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        r_abstract(ref_config(cfg), r_decls(ref_config(cfg))))
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1])
            for k, t in got.items()} == want
    assert all(t.device.type == "meta" for t in got.values())


def test_positions_are_the_reference_broadcast():
    from repro.training import make_positions as r_positions

    tok = np.zeros((3, 7), np.int32)
    got = make_positions({"tokens": torch.tensor(tok)})
    want = np.asarray(r_positions({"tokens": jnp.asarray(tok)}))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    emb = make_positions({"embeds": torch.zeros((2, 5, 4))})
    assert tuple(emb.shape) == (2, 5)

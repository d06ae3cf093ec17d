"""Tensor-parallel compute over ``model`` on meshes of CPU slots.

* Every arch reduced (the six dense ones; mixtral's experts,
  deepseek-v3's MLA and experts, recurrentgemma's RG-LRU and mamba2's
  SSD), float32, on (1, 4), (2, 2) and (2, 4) slots: two train steps with
  ``grad_accum`` 1 and 2 (the schedule's lr 0, then its peak), then
  prefill and greedy decode in decode rules, against the port's
  unsharded step and engine within the bounds of
  `tests/test_torch_mesh_train.py` (metrics rtol 2e-4 / atol 2e-5;
  params and optimizer state 1e-4 of each leaf's scale under
  `train_tree_gap`) and `tests/test_torch_mesh_serve.py` (tokens equal,
  logits 1e-4 of their scale).
* The MoE's layouts on (2, 4): experts over ``model`` (8 on 4); 6
  experts, replicated in train rules, their ``d_model`` or (wider
  experts) ``expert_ff`` cut by the decode rules' fallback; and a
  capacity low enough that tokens are dropped.
* The split, read from `COLLECTIVES` and `TRAFFIC`: in a train step no
  weight all-gather has a group larger than the data size, the
  all-reduces over ``model`` carry the activations' bytes; decode
  gathers no weight of the mixers, FFNs, embedding or head, and opens
  the recurrent states in their pieces.
* A dense block, a mixer or an MoE FFN meeting a spec no product takes
  raises.
* The vocab-parallel cross-entropy against `torch.logsumexp`, and the
  autograd functions that move activations between a data slot and its
  model slots, or between its model slots.

A mesh step sums its products' partial sums over model slots and its
gradients over data slots, so its float32 sums run in another order
than the unsharded step's: 1e-4 of scale, not 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_differential import (adam_drift_bound, lm_train_batch,
                                train_tree_gap)

from repro_torch.configs import get_config
from repro_torch.distributed import (batch_shardings, device_put, gather,
                                     make_mesh, make_rules,
                                     sanitized_shardings)
from repro_torch.distributed.placement import (COLLECTIVES, TRAFFIC,
                                               all_reduce_max,
                                               from_model_slots,
                                               gather_model_parts,
                                               reduce_scatter_model,
                                               regroup_model, reset_traffic,
                                               to_model_slots)
from repro_torch.nn import flatten_tree, init_params, model_decls
from repro_torch.nn.common import ShardCtx, Split, map_tree
from repro_torch.nn.model import loss_parts, vocab_parallel_xent
from repro_torch.serving import ServeEngine
from repro_torch.training import (OptHParams, TrainHParams, make_train_step,
                                  train_state_init, train_state_pspecs)
from repro_torch.training.train_step import make_positions

DENSE = ["deepseek-coder-33b", "gemma2-27b", "internvl2-76b",
         "musicgen-large", "qwen2.5-3b", "starcoder2-3b"]
MIXED = ["deepseek-v3-671b", "mamba2-370m", "mixtral-8x22b",
         "recurrentgemma-2b"]
MESHES = [(1, 4), (2, 2), (2, 4)]
STATE_REL, RTOL, ATOL, BOUND = 1e-4, 2e-4, 2e-5, 1e-4
OPT = OptHParams(learning_rate=1e-3, warmup_steps=1, total_steps=10)
ROWS, SEQ = 8, 16
BATCH, PROMPT, CACHE, NEW = 4, 12, 32, 4
SAME = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    cfg = get_config(arch).reduced(compute_dtype="float32")
    return dataclasses.replace(cfg, moe_groups=2) if cfg.n_experts else cfg


def _params(cfg):
    return init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                       device="cpu")


def _placed(cfg, params, mesh, rules):
    state = train_state_init(map_tree(lambda t: t.clone(), params), cfg)
    return device_put(state, sanitized_shardings(
        mesh, train_state_pspecs(cfg, model_decls(cfg), rules), state))


def _batch(cfg, seed, mesh=None, rules=None):
    batch = {k: torch.as_tensor(v)
             for k, v in lm_train_batch(cfg, ROWS, SEQ, seed=seed).items()}
    return batch if mesh is None else device_put(
        batch, batch_shardings(mesh, rules, batch))


def _train_matches(cfg, params, mesh, grad_accum):
    hp = TrainHParams(opt=OPT, grad_accum=grad_accum)
    rules = make_rules(mesh, "train")
    ref = train_state_init(map_tree(lambda t: t.clone(), params), cfg)
    state = _placed(cfg, params, mesh, rules)
    ref_step, step = make_train_step(cfg, hp), make_train_step(cfg, hp, mesh,
                                                               rules)
    for i in range(2):
        ref, rmet = ref_step(ref, _batch(cfg, i))
        state, met = step(state, _batch(cfg, i, mesh, rules))
        for k in rmet:
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=RTOL, atol=ATOL)
    host = gather(state, "cpu")
    ropt, topt = flatten_tree(ref["opt"]), flatten_tree(host["opt"])
    gap = train_tree_gap(flatten_tree(host["params"]),
                         flatten_tree(ref["params"]), STATE_REL,
                         opt=(topt, ropt) if cfg.optimizer == "adamw"
                         else None, drift=adam_drift_bound(OPT, range(2)))
    assert gap["worst"] <= STATE_REL, gap
    ogap = train_tree_gap(topt, ropt, STATE_REL)
    assert ogap["worst"] <= STATE_REL, ogap


def _gap(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _serve_matches(cfg, params, mesh):
    # an embeds backbone is served on tokens, as the launchers serve it
    gcfg = dataclasses.replace(cfg, input_kind="tokens")
    params, cfg = (params if gcfg == cfg else _params(gcfg)), gcfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    ptok, plog = ServeEngine(cfg, params, cache_len=CACHE,
                             device="cpu").generate(prompts, NEW,
                                                    with_logits=True)
    eng = ServeEngine(cfg, params, cache_len=CACHE, mesh=mesh,
                      rules=make_rules(mesh, "decode"))
    tok, log = eng.generate(prompts, NEW, with_logits=True)
    assert torch.equal(tok, ptok)
    assert _gap(log, plog) <= BOUND


CASES = [(a, m) for a in DENSE + MIXED for m in MESHES]


@pytest.mark.parametrize("arch,mesh_shape", CASES)
def test_tensor_parallel_mesh_matches_unsharded(arch, mesh_shape):
    cfg = _cfg(arch)
    params = _params(cfg)
    mesh = make_mesh(mesh_shape, ("data", "model"), devices=SAME)
    for grad_accum in (1, 2):
        if grad_accum == 2 and ROWS // 2 % mesh_shape[0]:
            continue
        _train_matches(cfg, params, mesh, grad_accum)
    _serve_matches(cfg, params, mesh)


def _spec_of(cfg, mesh, kind, leaf):
    """``leaf``'s sanitized spec (no leading layer axis) under ``kind``'s
    rules, as the train step and the engine place it."""
    rules = make_rules(mesh, kind)
    decls = model_decls(cfg)
    if kind == "train":
        tree = train_state_pspecs(cfg, decls, rules)["params"]
        sh = sanitized_shardings(mesh, tree, decls)
    else:
        from repro_torch.nn.common import param_pspecs

        sh = sanitized_shardings(mesh, param_pspecs(decls, rules), decls,
                                 tp_fallback_axis="model")
    return tuple(flatten_tree(sh)[leaf].spec)[1:]


MOE_LAYOUTS = {
    # layout: (config overrides, gate's spec in train rules, in decode)
    "experts": ({}, ("model", "data", None), ("model", None, None)),
    "replicated_then_d_model": ({"n_experts": 6}, (None, "data", None),
                                (None, "model", None)),
    "replicated_then_expert_ff": ({"n_experts": 6, "moe_d_ff": 256},
                                  (None, "data", None),
                                  (None, None, "model")),
}


@pytest.mark.parametrize("layout", sorted(MOE_LAYOUTS))
def test_moe_layouts_match_unsharded(layout):
    """mixtral reduced on (2, 4): its experts over ``model`` (8 on 4,
    each slot its experts' rows of the capacity buffer), or 6 experts,
    replicated over ``model`` in train rules and cut over ``d_model``
    (``gate``/``up`` row-, ``down`` column-parallel) or, wider than
    ``d_model``, over ``expert_ff`` by the decode rules' fallback."""
    over, train_spec, decode_spec = MOE_LAYOUTS[layout]
    cfg = dataclasses.replace(_cfg("mixtral-8x22b"), **over)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    gate = "stage0/slot0/ffn/gate"
    got = (_spec_of(cfg, mesh, "train", gate),
           _spec_of(cfg, mesh, "decode", gate))
    assert got == (train_spec, decode_spec)
    params = _params(cfg)
    _train_matches(cfg, params, mesh, 1)
    _serve_matches(cfg, params, mesh)


def test_capacity_drops_equal_the_unsharded():
    """With a capacity factor of 0.5 each group keeps about a quarter of
    its routed slots (the unsharded forward's logits move), and the mesh
    drops the same ones: its train steps, prefill and decode equal the
    unsharded ones (deepseek-v3: sigmoid routing and a shared expert)."""
    from repro_torch.nn.model import forward

    base = _cfg("deepseek-v3-671b")
    cfg = dataclasses.replace(base, capacity_factor=0.5)
    params = _params(cfg)
    batch = _batch(cfg, 0)
    ctx = ShardCtx(positions=make_positions(batch),
                   compute_dtype=torch.float32)
    full, _, _ = forward(params, batch, base, ctx)
    cut, _, _ = forward(params, batch, cfg, ctx)
    assert float((full - cut).abs().max()) > 1e-2 * float(full.abs().max())
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    for grad_accum in (1, 2):
        _train_matches(cfg, params, mesh, grad_accum)
    _serve_matches(cfg, params, mesh)


def test_an_rglru_whose_width_does_not_split_runs_on_the_data_slot():
    """recurrentgemma with an RG-LRU width of 126 on (2, 4): ``ff`` does
    not split 4 ways, so `sanitize_spec` leaves every weight of the block
    replicated over ``model`` and the block runs whole on each data
    slot (its weights gathered over the data axes only), as XLA
    replicates it; the train steps equal the unsharded ones."""
    cfg = dataclasses.replace(_cfg("recurrentgemma-2b"), rglru_width=126)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    assert _spec_of(cfg, mesh, "train", "stage0/slot0/mixer/rec_proj") \
        == ("data", None)
    params = _params(cfg)
    for grad_accum in (1, 2):
        _train_matches(cfg, params, mesh, grad_accum)


def _gathered(monkeypatch, params) -> list:
    """A list the weight all-gathers append ``(leaf name, pieces)`` to;
    a layer's leaf is named by the stacked leaf its pieces are views
    of."""
    import repro_torch.distributed.placement as pl

    names = {x.pieces[0].untyped_storage().data_ptr(): k
             for k, x in flatten_tree(params).items()}
    seen = []
    real = pl._AllGather.forward

    def spy(ctx, meta, *pieces):
        seen.append((names.get(pieces[0].untyped_storage().data_ptr()),
                     len(pieces)))
        return real(ctx, meta, *pieces)

    monkeypatch.setattr(pl._AllGather, "forward", staticmethod(spy))
    return seen


SPLIT_WEIGHTS = ("ffn/gate", "ffn/up", "ffn/down", "ffn/shared/", "wq_b",
                 "wk_b", "wv_b", "mixer/wo", "gate_proj", "rec_proj", "w_a",
                 "w_x", "out_proj", "in_proj")


@pytest.mark.parametrize("arch", MIXED)
def test_collectives_show_the_mixers_split(arch, monkeypatch):
    """On (2, 4): in a train step no weight of the MoE FFN, MLA, the
    RG-LRU or SSD named above is all-gathered over more pieces than the
    data size (FSDP's gather of its model slot's block); in decode rules
    none of them is gathered at all, and every SSD and RG-LRU state
    opens as a `Split` of its model slots' pieces (no gather, no write
    back)."""
    import repro_torch.distributed.placement as pl

    cfg = _cfg(arch)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    rules = make_rules(mesh, "train")
    state = _placed(cfg, _params(cfg), mesh, rules)
    seen = _gathered(monkeypatch, state["params"])
    step = make_train_step(cfg, TrainHParams(opt=OPT), mesh, rules)
    step(state, _batch(cfg, 0, mesh, rules))
    ours = [(k, n) for k, n in seen
            if k and any(w in k for w in SPLIT_WEIGHTS)]
    assert ours and max(n for _, n in ours) <= 2
    eng = ServeEngine(cfg, _params(cfg), cache_len=CACHE, mesh=mesh,
                      rules=make_rules(mesh, "decode"))
    _, st = eng.prefill(torch.zeros((BATCH, PROMPT), dtype=torch.int32))
    seen = _gathered(monkeypatch, eng.params)
    kinds = []
    real = pl.open_cache

    def spy(tree, ctx, *dims):
        view, close = real(tree, ctx, *dims)
        kinds.extend((k, type(v).__name__) for k, v in view.items())
        return view, close

    monkeypatch.setattr(pl, "open_cache", spy)
    eng.decode(torch.zeros(BATCH, dtype=torch.int32), st)
    assert not [k for k, _ in seen
                if k and any(w in k for w in SPLIT_WEIGHTS)]
    states = [t for k, t in kinds if k in ("h", "state", "conv_tail")]
    assert all(t == "Split" for t in states)
    assert bool(states) == (arch in ("mamba2-370m", "recurrentgemma-2b"))


def _bsd_bytes(cfg, rows):
    return rows * SEQ * cfg.d_model * 4


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-3b"])
def test_collectives_show_the_split(arch):
    """qwen2.5-3b's 2 kv heads do not split 4 ways (wk, wv replicated
    over ``model``: k and v computed on the data slot, their gradients
    all-reduced); starcoder2-3b's 2 kv heads do not either, and its MLP
    has biases.  Per data slot and layer the all-reduces over ``model``
    carry, in float32, the residual stream's (b, s, d) four times —
    the attention's and the MLP's output forward, their input's gradient
    backward — and the replicated k/v's gradients; the embedding's rows
    and the head's input gradient once each; the loss's max, sum of
    exponentials and label logit, (b, s) each."""
    cfg = _cfg(arch)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    rules = make_rules(mesh, "train")
    state = _placed(cfg, _params(cfg), mesh, rules)
    step = make_train_step(cfg, TrainHParams(opt=OPT), mesh, rules)
    reset_traffic()
    step(state, _batch(cfg, 0, mesh, rules))
    gathers = {g for (k, _, g) in COLLECTIVES if k == "all-gather"}
    assert gathers and max(gathers) <= 2  # the data size
    reduced = sum(r["result_bytes"] for (k, _, g), r in COLLECTIVES.items()
                  if k == "all-reduce" and g == 4)
    b = ROWS // 2
    kv = b * SEQ * cfg.n_kv_heads * cfg.head_dim * 4
    per_slot = ((4 * cfg.n_layers + 2) * _bsd_bytes(cfg, b)
                + 2 * cfg.n_layers * kv + 3 * b * SEQ * 4)
    assert reduced == 2 * per_slot
    # decode rules: weights replicated over data, used in their pieces
    eng = ServeEngine(cfg, _params(cfg), cache_len=CACHE, mesh=mesh,
                      rules=make_rules(mesh, "decode"))
    _, st = eng.prefill(torch.zeros((BATCH, PROMPT), dtype=torch.int32))
    reset_traffic()
    eng.decode(torch.zeros(BATCH, dtype=torch.int32), st)
    # the only weights gathered: the stacked norm scales (and biases),
    # which the decode rules' fallback cuts over ``model``, as the
    # reference's placement does; nothing of the attention, MLP,
    # embedding or head
    norms = [x for k, x in flatten_tree(eng.params).items()
             if "norm" in k and "model" in tuple(x.spec)]
    assert TRAFFIC["gather_bytes"] == 2 * sum(
        4 * int(np.prod(x.shape)) for x in norms)
    assert not any(k == "reduce-scatter" for k, _, _ in COLLECTIVES)
    assert any(k == "all-reduce" and g == 4 for k, _, g in COLLECTIVES)


@pytest.mark.parametrize("arch,leaf,spec", [
    ("qwen2.5-3b", "stage0/slot0/mixer/wq", ("data", None, "model")),
    ("qwen2.5-3b", "stage0/slot0/ffn/gate", (("data", "model"), None)),
    ("mixtral-8x22b", "stage0/slot0/ffn/gate",
     (("data", "model"), None, None)),
    ("deepseek-v3-671b", "stage0/slot0/mixer/wq_b",
     (None, ("data", "model"), None)),
    ("recurrentgemma-2b", "stage0/slot0/mixer/w_a",
     (("data", "model"), None)),
    ("mamba2-370m", "stage0/slot0/mixer/in_proj", ("model", None)),
], ids=["wq_over_head_dim", "gate_over_data_and_model",
        "experts_over_data_and_model", "wq_b_heads_over_data_and_model",
        "rglru_w_a_over_data_and_model", "ssd_in_proj_row_parallel"])
def test_a_dense_block_raises_on_a_spec_no_product_takes(arch, leaf, spec):
    """A dense block, a mixer or an MoE FFN whose weight is cut so that
    no product of its takes it raises: nothing falls back to gathering
    it."""
    from repro_torch.distributed import NamedSharding, PartitionSpec

    cfg = _cfg(arch)
    mesh = make_mesh((2, 2), ("data", "model"), devices=SAME)
    rules = make_rules(mesh, "train")
    state = train_state_init(_params(cfg), cfg)
    shard = sanitized_shardings(mesh, train_state_pspecs(
        cfg, model_decls(cfg), rules), state)
    flat = flatten_tree(shard["params"])
    flat[leaf] = NamedSharding(mesh, PartitionSpec(None, *spec))
    from repro_torch.nn import unflatten_tree

    shard["params"] = unflatten_tree(flat)
    placed = device_put(state, shard)
    step = make_train_step(cfg, TrainHParams(opt=OPT), mesh, rules)
    with pytest.raises(ValueError):
        step(placed, _batch(cfg, 0, mesh, rules))


def _ctx(m=4):
    mesh = make_mesh((1, m), ("data", "model"), devices=["cpu"] * m)
    return ShardCtx(compute_dtype=torch.float32, rules=make_rules(mesh),
                    mesh=mesh, device=torch.device("cpu"), rows=(0, 2))


def test_vocab_parallel_xent_equals_logsumexp():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 8, 64), generator=g) * 6
    labels = torch.randint(0, 64, (2, 8), generator=g)
    ctx = _ctx()
    logz, ll = vocab_parallel_xent(Split(list(logits.split(16, -1)), 2),
                                   labels, ctx)
    torch.testing.assert_close(logz, torch.logsumexp(logits, -1), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(ll, torch.take_along_dim(logits, labels[..., None],
                                                -1)[..., 0])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b",
                                  "starcoder2-3b"],
                         ids=["tied", "tied_softcap", "untied"])
def test_loss_parts_over_vocab_equal_the_unsharded(arch):
    """The loss's sums over a data slot's rows, masked tokens included:
    on a (1, 4) mesh the logits are cut over vocab (tied heads by the
    table's pieces) and the cross-entropy taken over the cut."""
    cfg = _cfg(arch)
    params = _params(cfg)
    batch = {k: torch.as_tensor(v)
             for k, v in lm_train_batch(cfg, 2, SEQ, seed=3).items()}
    batch["mask"] = (torch.arange(SEQ) % 3 != 0).float().expand(2, SEQ)
    want = loss_parts(params, batch, cfg, ShardCtx(
        positions=make_positions(batch), compute_dtype=torch.float32))
    ctx = _ctx()
    ctx.positions = make_positions(batch)
    placed = device_put(params, sanitized_shardings(
        ctx.mesh, train_state_pspecs(cfg, model_decls(cfg), ctx.rules)
        ["params"], params))
    head = placed["lm_head"]["kernel"] if "lm_head" in placed \
        else placed["embed"]["table"]
    assert ctx.tp and "model" in tuple(head.spec)
    got = loss_parts(placed, batch, cfg, ctx)
    for k in ("xent", "zsq", "count"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)


def test_the_moves_between_a_data_slot_and_its_model_slots():
    """`to_model_slots`: copies forward, the gradients' all-reduce back;
    `from_model_slots`: the partial sums' all-reduce, the gradient to
    each slot back; `gather_model_parts`: an all-gather, cut back;
    `all_reduce_max`: no gradient.  Each recorded with the model size as
    its group and the activation's bytes."""
    devs = [torch.device("cpu", i) for i in range(4)]
    home = devs[0]
    reset_traffic()
    x = torch.randn(3, 5, requires_grad=True)
    copies = to_model_slots(x, devs, home, slot=0)
    assert len(copies) == 4 and all(torch.equal(c, x) for c in copies)
    sum((c * (i + 1)).sum() for i, c in enumerate(copies)).backward()
    assert torch.equal(x.grad, torch.full((3, 5), 10.0))
    parts = [torch.randn(3, 5, requires_grad=True) for _ in devs]
    total = from_model_slots(parts, home, devs, slot=0)
    torch.testing.assert_close(total, sum(p.detach() for p in parts))
    (total * 2).sum().backward()
    assert all(torch.equal(p.grad, torch.full((3, 5), 2.0)) for p in parts)
    cut = [torch.randn(3, 2, requires_grad=True) for _ in devs]
    joined = gather_model_parts(cut, 1, home, devs, slot=0)
    assert torch.equal(joined, torch.cat([c.detach() for c in cut], 1))
    (joined * torch.arange(8.0)).sum().backward()
    assert torch.equal(cut[3].grad, torch.tensor([[6.0, 7.0]] * 3))
    mx = all_reduce_max([p.detach() for p in parts], home, slot=0)
    assert torch.equal(mx, torch.stack([p.detach() for p in parts]).amax(0))
    assert not mx.requires_grad
    n = 3 * 5 * 4
    want = {("all-reduce", 0, 4): {"calls": 3, "operand_bytes": 3 * 4 * n,
                                   "result_bytes": 3 * n},
            ("all-gather", 0, 4): {"calls": 1, "operand_bytes": 3 * 8 * 4,
                                   "result_bytes": 3 * 8 * 4}}
    assert COLLECTIVES == want
    assert not any(TRAFFIC.values())


def test_the_moves_between_model_slots():
    """`reduce_scatter_model`: the partial sums' reduce-scatter (each
    slot its block), the blocks' gradients all-gathered onto every slot
    back; `regroup_model`: each slot the ranges it asks for from the
    parts holding them, the gradients sent back and added where two
    slots asked for the same range, a collective-permute of what crossed
    between slots each way, issued by the slot that asked."""
    devs = [torch.device("cpu", i) for i in range(4)]
    reset_traffic()
    parts = [torch.randn(3, 8, requires_grad=True) for _ in devs]
    blocks = reduce_scatter_model(parts, 1, devs, slot=0)
    total = sum(p.detach() for p in parts)
    for m, b in enumerate(blocks):
        torch.testing.assert_close(b, total[:, 2 * m:2 * m + 2])
    sum((b * (m + 1)).sum() for m, b in enumerate(blocks)).backward()
    want = torch.tensor([1.0, 1, 2, 2, 3, 3, 4, 4]).expand(3, 8)
    assert all(torch.equal(p.grad, want) for p in parts)
    n = 3 * 8 * 4
    assert COLLECTIVES == {
        ("reduce-scatter", 0, 4): {"calls": 1, "operand_bytes": n,
                                   "result_bytes": n},
        ("all-gather", 0, 4): {"calls": 1, "operand_bytes": n,
                               "result_bytes": n}}
    reset_traffic()
    x = torch.arange(24.0).reshape(2, 12)
    cut = [t.clone().requires_grad_(True) for t in x.split([3, 3, 3, 3], 1)]
    have = [(0, 3), (3, 6), (6, 9), (9, 12)]
    need = [[(0, 1), (10, 12)], [(3, 6)], [(2, 5)], [(10, 12)]]
    got = regroup_model(cut, 1, have, need, devs, [10, 11, 12, 13], slot=1)
    for ranges, ts in zip(need, got):
        for (a, b), t in zip(ranges, ts):
            assert torch.equal(t, x[:, a:b])
    sum(t.sum() for ts in got for t in ts).backward()
    assert torch.equal(cut[3].grad[0], torch.tensor([0.0, 2.0, 2.0]))
    assert torch.equal(cut[0].grad[0], torch.tensor([1.0, 0.0, 1.0]))
    assert torch.equal(cut[1].grad[0], torch.tensor([2.0, 2.0, 1.0]))
    # slot 0 takes 2 columns of part 3; slot 2 one of part 0 and two of
    # part 1; slot 3 none from another part; each way, 2 rows of float32
    assert COLLECTIVES == {
        ("collective-permute", (1, 10), 4): {
            "calls": 2, "operand_bytes": 32, "result_bytes": 32},
        ("collective-permute", (1, 12), 4): {
            "calls": 2, "operand_bytes": 48, "result_bytes": 48}}

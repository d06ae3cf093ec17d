"""The port's operator-level roofline analyzer (`repro_torch.roofline`):
the properties `tests/test_roofline.py` holds the reference's HLO
analyzer to — hand-computable matmuls exact, an L-layer stack L times
one layer, a one-row cache write counted at the row and not the buffer —
and its own: `FlopCounterMode`'s count on the same call, views free,
peak live bytes, the placement layer's collectives, and the RG-LRU
scan walked once on ``meta`` counted for every step."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.distributed import (TRAFFIC, compressed_psum, device_put,
                                     make_mesh, reset_traffic)
from repro_torch.distributed.placement import COLLECTIVES
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec
from repro_torch.nn import init_params, model_decls
from repro_torch.roofline import (COLLECTIVE_KINDS, OpCounter, analyze_step,
                                  collective_link_bytes)
from repro_torch.training import (TrainHParams, make_train_step,
                                  train_state_init)

META = "meta"


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_hand_computable_matmuls_exact():
    a, b = _t(16, 32), _t(32, 64)
    assert analyze_step(lambda: a @ b).flops == 2 * 16 * 32 * 64
    x, w = _t(3, 16, 32), _t(3, 32, 8)
    assert analyze_step(torch.bmm, x, w).flops == 2 * 3 * 16 * 32 * 8
    bias = _t(64)
    assert analyze_step(torch.addmm, bias, a, b).flops == 2 * 16 * 32 * 64
    c = analyze_step(lambda: torch.einsum("bsd,dhk->bshk", _t(2, 8, 32),
                                          _t(32, 4, 16)))
    assert c.flops == 2 * (2 * 8) * 32 * (4 * 16)
    # element-wise work and reductions are not FLOPs here (as in the
    # reference: only dot and convolution are)
    assert analyze_step(lambda: (a * 2).exp().sum()).flops == 0


def test_equals_flop_counter_mode_on_a_train_step():
    """The count is `FlopCounterMode`'s on the same call (CPU tensors, a
    reduced arch's whole train step: forward, backward, optimizer)."""
    cfg = get_config("qwen2.5-3b").reduced()
    decls = model_decls(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(0)
                                     ).int(),
             "labels": torch.zeros((2, 16), dtype=torch.int32),
             "mask": torch.ones((2, 16))}
    step = make_train_step(cfg, TrainHParams())

    def state():
        return train_state_init(init_params(
            decls, torch.Generator().manual_seed(0), "cpu"), cfg)

    got = analyze_step(step, state(), batch)
    with FlopCounterMode(display=False) as fc:
        step(state(), batch)
    assert got.flops == fc.get_total_flops() > 0


@pytest.mark.parametrize("n_layers", [1, 3, 7])
def test_stack_counts_layers_times_one_layer(n_layers):
    d, f = 32, 64
    x = _t(16, d)
    ws = [(_t(d, f), _t(f, d)) for _ in range(n_layers)]

    def stack():
        y = x
        for w0, w1 in ws:
            y = torch.tanh(y @ w0) @ w1
        return y.sum()

    one = analyze_step(lambda: torch.tanh(x @ ws[0][0]) @ ws[0][1])
    c = analyze_step(stack)
    assert c.flops == n_layers * one.flops == n_layers * 2 * (2 * 16 * d * f)
    assert c.ops_by_name["mm"] == 2 * n_layers


def test_stack_backward_is_twice_the_forward():
    d, f, n = 32, 64, 5
    x = torch.empty((16, d), device=META)
    ws = [torch.empty((d, f), device=META, requires_grad=True)
          for _ in range(n)]

    def fwd_bwd():
        y = x
        for w in ws:
            y = torch.tanh(y @ w) @ w.t()
        y.sum().backward()

    fwd = 2 * n * 2 * 16 * d * f
    # each matmul's backward: one product for its weight and one for its
    # input, except the first layer's input (x needs no gradient)
    assert analyze_step(fwd_bwd).flops == fwd + 2 * fwd - 2 * 16 * d * f


def test_one_row_cache_write_counts_the_row_not_the_buffer():
    buf, row = _t(4096, 512), _t(1, 512)
    nbytes = 512 * 4

    def write_slice():
        buf[7:8] = row

    def write_index():
        buf[torch.tensor([7], device=META)] = row

    for fn in (write_slice, write_index):
        c = analyze_step(fn)
        # the reference's bound for its dynamic-update-slice: about 2x the
        # row, nowhere near the 8 MiB buffer
        assert c.hbm_bytes <= 4 * 512 * 4 * 2 + 1024, (fn, c.hbm_bytes)
        assert c.kernel_bytes <= 4 * nbytes + 1024, (fn, c.kernel_bytes)
    c = analyze_step(write_slice)
    assert c.hbm_bytes == c.kernel_bytes == 2 * nbytes
    assert c.hbm_by_op == {"dynamic-update-slice": 2 * nbytes}
    c = analyze_step(write_index)
    assert c.hbm_by_op == {"scatter": 3 * nbytes + 8}


def test_views_launch_nothing_and_fused_ops_move_no_hbm():
    x = _t(8, 16, 32)
    c = analyze_step(lambda: x.reshape(128, 32).t()[3:9].unsqueeze(0)
                     .permute(2, 0, 1).expand(128, 2, 6).narrow(1, 0, 1))
    assert c.ops == 0 and c.kernel_bytes == 0 and c.hbm_bytes == 0
    # element-wise ops of the reference's fused set launch kernels and
    # move bytes in the eager port, none in the fusion-optimistic model
    c = analyze_step(lambda: (x * 2 + 1).to(torch.bfloat16).clone())
    assert c.ops == 4
    assert c.kernel_bytes == 2 * (2 * x.numel() * 4) + x.numel() * (4 + 2) \
        + 2 * x.numel() * 2
    assert c.hbm_bytes == 0
    # a reduction and a matmul are HBM round trips of their operands
    c = analyze_step(lambda: x.sum(-1))
    assert c.hbm_by_op == {"sum": x.numel() * 4 + 8 * 16 * 4}
    # a fill is free in HBM (XLA's broadcast) but is a kernel here
    c = analyze_step(lambda: torch.zeros((64, 64), device=META))
    assert (c.ops, c.hbm_bytes, c.kernel_bytes) == (1, 0, 64 * 64 * 4)
    # a 3-D matmul is an ``mm`` between views, the last an
    # ``_unsafe_view`` (a view the schema does not mark): one kernel
    w = _t(32, 64)
    c = analyze_step(lambda: x @ w)
    assert c.ops_by_name == {"mm": 1}
    assert c.hbm_bytes == c.kernel_bytes == (x.numel() + w.numel()
                                             + 8 * 16 * 64) * 4


def test_peak_live_bytes():
    n = 1000

    def f():
        a = torch.zeros(n, device=META)  # 4 KB
        b = a * 2  # 8 KB live
        del a
        c = b + 1  # 8 KB live
        d = c.view(10, 100)  # a view: nothing new
        del b
        return d.sum()

    c = analyze_step(f)
    assert c.peak_live_bytes == 2 * 4 * n
    x = _t(n)
    c = analyze_step(lambda: x.add_(1))  # in place: allocates nothing
    assert c.peak_live_bytes == 0
    with OpCounter("a") as oc:
        keep = torch.zeros(n, device=META)
        oc.phase("b")
        torch.zeros(2 * n, device=META)
    assert oc.costs["a"].peak_live_bytes == 4 * n
    assert oc.costs["b"].peak_live_bytes == 8 * n  # above the phase's start
    assert oc.total().peak_live_bytes == 12 * n
    del keep


def test_collectives_from_the_placement_layer():
    """An all-gather of a leaf cut 4 ways and its backward reduce-scatter
    on a (2, 2) mesh of ``meta`` slots: the reference's ring factors, the
    raw bytes equal to `TRAFFIC`'s, which the analyzer leaves as it is."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=[META] * 4)
    w = torch.empty((64, 32), device=META)
    placed = device_put({"w": w}, {"w": NamedSharding(
        mesh, PartitionSpec("data", "model"))})["w"]
    placed = dataclasses.replace(placed, pieces=[
        p.detach().requires_grad_(True) for p in placed.pieces])
    reset_traffic()
    c = analyze_step(lambda: placed.full(torch.device(META), 0).sum()
                     .backward())
    nbytes = 64 * 32 * 4
    assert c.coll_counts == {"all-gather": 1, "reduce-scatter": 1}
    assert c.coll_raw["all-gather"] == {"calls": 1, "operand_bytes": nbytes,
                                        "result_bytes": nbytes}
    assert c.coll_bytes["all-gather"] == nbytes * 3 / 4
    assert c.coll_bytes["reduce-scatter"] == nbytes * 3 / 4
    assert c.coll_by_slot == {0: nbytes * 3 / 2}
    assert TRAFFIC == {"gather_bytes": nbytes, "reduce_scatter_bytes": nbytes}
    assert c.hbm_by_op["all-gather"] == 2 * nbytes
    assert {k for k, _, _ in COLLECTIVES} == {"all-gather", "reduce-scatter"}
    reset_traffic()
    assert not COLLECTIVES and not any(TRAFFIC.values())


def test_int8_all_reduce_is_counted():
    parts = [torch.randn(100, generator=torch.Generator().manual_seed(i))
             for i in range(4)]
    c = analyze_step(compressed_psum, parts)
    assert c.coll_counts == {"all-reduce": 2}
    assert c.coll_raw["all-reduce"] == {
        "calls": 2, "operand_bytes": 4 * 4 + 4 * 100,
        "result_bytes": 4 + 4 * 100}


@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
def test_ring_factors_are_the_reference_s(kind):
    want = {"all-reduce": 2 * 800 * 3 / 4, "all-gather": 800 * 3 / 4,
            "reduce-scatter": 200 * 3 / 4, "all-to-all": 800 * 3 / 4,
            "collective-permute": 800.0}[kind]
    assert collective_link_bytes(kind, 800, 200, 4) == want


@pytest.mark.parametrize("steps", [3, 64])
def test_a_scan_walked_once_on_meta_counts_every_step(steps):
    """The RG-LRU scan on ``meta`` walks one step for all of them
    (`placement.repeated`): its forward and backward counts equal those
    of the same scan walked step by step on the CPU."""
    from repro_torch.nn.rglru import linear_scan

    def counts(device):
        a = torch.rand((2, steps, 8), device=device, requires_grad=True)
        b = torch.rand((2, steps, 8), device=device, requires_grad=True)
        with OpCounter() as oc:
            linear_scan(a, b).sum().backward()
        c = oc.total()
        return (c.ops, c.kernel_bytes, c.hbm_bytes, c.flops,
                dict(c.ops_by_name))

    assert counts("meta") == counts("cpu")


def test_the_scan_backward_equals_autograd_of_its_steps():
    """`linear_scan`'s backward walks the recurrence back: bit for bit
    the gradients autograd takes of the forward's steps."""
    from repro_torch.nn.rglru import linear_scan

    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 33, 5), generator=g, requires_grad=True)
    b = torch.randn((2, 33, 5), generator=g, requires_grad=True)
    w = torch.randn((2, 33, 5), generator=g)
    a2, b2 = (t.detach().clone().requires_grad_() for t in (a, b))
    h2 = torch.empty_like(b2)
    prev = b2[:, 0]
    h2[:, 0] = prev
    for t in range(1, 33):
        prev = a2[:, t] * prev + b2[:, t]
        h2[:, t] = prev
    (linear_scan(a, b) * w).sum().backward()
    (h2 * w).sum().backward()
    assert torch.equal(a.grad, a2.grad) and torch.equal(b.grad, b2.grad)

"""One data slot traced and charged to each (`repro_torch.launch.dryrun`)
against every slot traced, as one device runs the mesh: on a (2, 2) and
a (4, 1) mesh of ``meta`` slots, for all ten archs reduced; and the dry
run of a (2, 4) cell against one real train step on CPU slots.

The FLOPs, the collectives and (serving) the bytes are the slot's times
the data size exactly.  What runs once a step whatever the slot count is
charged once: the gradient zeroing over the mesh's pieces, the update;
what differs is the loss's combination of the slots' sums (a dozen
scalar ops and their backward a slot: its ops, bytes and fused-model
bytes bounded below) and the logits' concatenation (one op instead of
one a slot).

Memory: a one-slot trace's peak is one slot's temporaries, which the
per-device figures use.  Every slot on one device holds at least that
and at most the data size times it.  Adding every slot's peak and the
gradient a slot's reduce-scatter leaves waiting for the other slots'
(`_one_device_bytes` of a one-slot trace) is an upper bound on every
slot on one device, since there the slots' transient buffers are not
all alive at once; `MEM_OVER` bounds how far above it lies at this size
(observed: train 1.15–1.29, prefill 1.01–1.42, decode 1.04–1.17)."""
import dataclasses

import pytest

from repro_torch.configs import ShapeSpec, all_configs, get_config
from repro_torch.launch.dryrun import (_one_device_bytes, build_cell,
                                       mesh_cost, trace_cell)

CASES = ([(a, (2, 2), k) for a in sorted(all_configs())
          for k in ("train", "prefill", "decode")]
         + [(a, (4, 1), "train") for a in sorted(all_configs())])
MEM_OVER = {"train": 1.35, "prefill": 1.5, "decode": 1.2}


@pytest.mark.parametrize("arch,mesh_shape,kind", CASES)
def test_one_slot_times_the_data_size_is_the_mesh(arch, mesh_shape, kind):
    cell = build_cell(arch, ShapeSpec(kind, 32, 8, kind),
                      mesh_shape=mesh_shape, cfg=get_config(arch).reduced())
    d = cell.n_data
    assert d == mesh_shape[0]
    one_tr, all_tr = trace_cell(cell), trace_cell(cell, all_slots=True)
    assert not one_tr["all_slots"] and all_tr["all_slots"]
    one, whole = mesh_cost(one_tr, d), mesh_cost(all_tr, d)
    assert one.flops == whole.flops > 0
    assert one.coll_raw == whole.coll_raw
    assert one.coll_counts == whole.coll_counts
    assert one.coll_bytes == whole.coll_bytes
    assert "all-gather" in whole.coll_raw
    extra = d - 1
    if kind == "train":
        assert 0 <= one.ops - whole.ops <= 64 * extra
        assert 0 <= one.kernel_bytes - whole.kernel_bytes <= 8192 * extra
        assert 0 <= one.hbm_bytes - whole.hbm_bytes <= 1024 * extra
    else:
        assert one.ops - whole.ops == extra  # the logits' concatenation
        assert one.kernel_bytes == whole.kernel_bytes
        assert one.hbm_bytes == whole.hbm_bytes
    assert one_tr["held"] == all_tr["held"]
    slot_peak = one_tr["oc"].costs["slot"].peak_live_bytes
    all_peak = all_tr["oc"].total().peak_live_bytes
    assert 0 < slot_peak <= all_peak <= d * slot_peak
    one_dev, all_dev = (_one_device_bytes(one_tr, d),
                        _one_device_bytes(all_tr, d))
    assert all_dev <= one_dev <= MEM_OVER[kind] * all_dev


def test_one_slot_memory_bound_counts_the_pending_gradient():
    """A deep, narrow step whose gradient outweighs its activations: the
    slots' temporaries added alone fall 7% below every slot on one device
    (as the full-width qwen2.5-3b cell of `chip_smoke.py` does on the
    card); with the pending gradient (`_pending`) they bound it."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              n_layers=16, d_ff=2048)
    cell = build_cell("qwen2.5-3b", ShapeSpec("t", 8, 2, "train"),
                      mesh_shape=(2, 4), cfg=cfg)
    one_tr, all_tr = trace_cell(cell), trace_cell(cell, all_slots=True)
    one_dev, all_dev = (_one_device_bytes(one_tr, 2),
                        _one_device_bytes(all_tr, 2))
    pending = one_tr["made"]["total"]
    assert one_dev - pending < all_dev <= one_dev <= MEM_OVER["train"] \
        * all_dev


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b",
                                  "mamba2-370m"])
def test_dry_run_equals_a_real_step_on_cpu_slots(arch):
    """The dry run of a (2, 4) cell on ``meta`` slots against one real
    train step on CPU slots, its parameters in the dtypes `init_params`
    gives them: its FLOPs are `FlopCounterMode`'s count of the step, its
    all-gather and reduce-scatter bytes the step's `TRAFFIC`, its
    all-reduces the step's `COLLECTIVES` (the card's counterpart:
    `tests/test_torch_cuda.py`)."""
    from torch_differential import dryrun_vs_step

    rep = dryrun_vs_step(arch, ["cpu"] * 8)
    raw = rep["dry"]["collective_raw_total"]
    assert rep["dry"]["op_flops_total"] == rep["flops"] > 0
    assert raw["all-gather"]["result_bytes"] == \
        rep["traffic"]["gather_bytes"] > 0
    assert raw["reduce-scatter"]["operand_bytes"] == \
        rep["traffic"]["reduce_scatter_bytes"] > 0
    # the all-reduces (over ``model``: the tensor-parallel products; the
    # clip's norm) are the step's `COLLECTIVES`, calls and bytes
    assert raw["all-reduce"] == rep["collectives"]["all-reduce"]

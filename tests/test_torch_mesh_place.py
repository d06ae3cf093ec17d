"""Placement on a mesh of device slots and the slot collectives.

Meshes of CPU slots: ``["cpu"] * 8`` (one device in every slot, as one
card runs a (2, 4) mesh) and ``cpu:0`` … ``cpu:7`` (eight slot devices
that lie on the CPU: a block replicated over them has one piece each, as
it would on eight cards).  Placement and gathers are exact (tolerance
0); the log-sum-exp merge of attention partials is held to float32
rounding (1e-6 of the output's scale) against one softmax over the union.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import (PartitionSpec, ShardedTensor,
                                     all_reduce_sum, device_put, gather,
                                     make_mesh, sync_replicas)
from repro_torch.distributed.placement import (SeqShards, data_slots,
                                               open_cache, placed_bytes,
                                               rows_of, zeros_placed)
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.nn.attention import NEG, combine_partials

SAME = ["cpu"] * 8
DISTINCT = [f"cpu:{i}" for i in range(8)]
SPECS = [(), ("data",), (None, "model"), ("data", "model"),
         (("data", "model"),), ("model", "data"), (None, None, "data")]


def _mesh(devices, shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), devices=devices)


def _x(shape=(8, 8, 4), seed=0):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape),
                        dtype=torch.float32)


@pytest.mark.parametrize("devices", ["same", "distinct"])
@pytest.mark.parametrize("spec", SPECS)
def test_device_put_then_gather_is_exact(spec, devices):
    mesh = _mesh(SAME if devices == "same" else DISTINCT)
    x = _x()
    st = device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))
    assert isinstance(st, ShardedTensor) and st.shape == (8, 8, 4)
    blocks = len(st.groups())
    split = [mesh.shape[a] for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))]
    assert blocks == int(np.prod(split))
    # one piece a distinct (device, block): repeated slots share it
    assert len(st.pieces) == (blocks if devices == "same" else 8)
    assert all(p.data_ptr() != x.data_ptr() for p in st.pieces)
    assert torch.equal(gather(st, "cpu"), x)
    for lo, hi in ((0, 8), (2, 6), (4, 8)):
        assert torch.equal(rows_of(st, lo, hi, "cpu"), x[lo:hi])
    # the slot files of a checkpoint: one a slot, in mesh order
    assert len(st.slot_pieces()) == 8
    whole = torch.zeros_like(x)
    for idx, p in st.slot_pieces():
        whole[tuple(slice(a, b) for a, b in idx)] = p
    assert torch.equal(whole, x)


def test_bytes_a_slot_follow_the_placement():
    x = _x()
    full = x.numel() * 4
    for devices, total in ((SAME, full), (DISTINCT, 4 * full)):
        st = device_put({"w": x}, {"w": NamedSharding(
            _mesh(devices), PartitionSpec("data"))})
        got = placed_bytes(st)
        assert got["total"] == total  # DISTINCT: 4 model replicas
        assert got["per_slot"] == [full // 2] * 8


def test_layer_view_and_zeros_follow_the_layout():
    mesh = _mesh(SAME)
    x = _x((3, 8, 4))
    st = device_put(x, NamedSharding(mesh, PartitionSpec(None, "data",
                                                         "model")))
    for r in range(3):
        lay = st[r]
        assert lay.shape == (8, 4) and lay.spec == ("data", "model")
        assert torch.equal(gather(lay, "cpu"), x[r])
    z = zeros_placed(st.sharding, st.shape, torch.float32)
    assert z.index == st.index and not any(p.any() for p in z.pieces)


@pytest.mark.parametrize("devices", ["same", "distinct"])
def test_all_gather_backward_is_the_reduce_scatter(devices):
    """Two data slots gather one placed weight and take a loss each;
    ``backward()`` over the sum leaves in every canonical piece the sum
    of the slots' gradients of its block (replicas then summed by
    `sync_replicas`)."""
    mesh = _mesh(SAME if devices == "same" else DISTINCT)
    x = _x((8, 4))
    st = device_put(x, NamedSharding(mesh, PartitionSpec("data", "model")))
    leaves = [p.detach().requires_grad_(True) for p in st.pieces]
    for t in leaves:
        t.grad = torch.zeros_like(t)
    lst = ShardedTensor(st.shape, st.dtype, st.sharding, st.index,
                        st.devices, leaves)
    a, b = _x((4, 8), 1), _x((4, 8), 2)
    outs = [(a @ lst.full(mesh.devices[0, 0])).square().sum(),
            (b @ lst.full(mesh.devices[1, 0])).sin().sum()]
    sum(outs).backward()
    w = x.clone().requires_grad_(True)
    ((a @ w).square().sum() + (b @ w).sin().sum()).backward()
    grads = ShardedTensor(st.shape, st.dtype, st.sharding, st.index,
                          st.devices, [t.grad for t in leaves])
    sync_replicas(grads)
    torch.testing.assert_close(gather(grads, "cpu"), w.grad, rtol=1e-6,
                               atol=1e-6)
    for ids in grads.groups().values():  # replicas equal after the sync
        assert all(torch.equal(grads.pieces[i], grads.pieces[ids[0]])
                   for i in ids)


def test_all_reduce_sum_adds_in_order_on_one_slot():
    fulls = [_x((8, 4), s) for s in range(3)]
    assert torch.equal(all_reduce_sum(fulls, "cpu:3"),
                       fulls[0] + fulls[1] + fulls[2])


def test_data_slots_split_the_rows():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=DISTINCT)
    slots = data_slots(mesh, {"batch": ("pod", "data")}, 8)
    assert [(d, lo, hi) for d, _, lo, hi in slots] == [
        (0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
    assert [str(dev) for _, dev, _, _ in slots] == ["cpu:0", "cpu:2",
                                                     "cpu:4", "cpu:6"]
    assert data_slots(mesh, {"batch": None}, 3) == [(0, mesh.devices[0, 0,
                                                                     0], 0, 3)]
    with pytest.raises(ValueError, match="global_batch"):
        data_slots(mesh, {"batch": ("pod", "data")}, 6)


def test_a_cache_split_on_its_sequence_is_opened_in_pieces():
    """An attention cache (B, Hkv, W, Dh) placed with its ring over
    ``model`` opens as `SeqShards` for a data slot; split on its heads it
    is gathered and written back on close."""
    from repro_torch.nn.common import ShardCtx

    mesh = _mesh(DISTINCT)
    k = _x((4, 2, 8, 3))
    pos = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    seq = {"k": device_put(k, NamedSharding(
               mesh, PartitionSpec("data", None, "model"))),
           "pos": device_put(pos, NamedSharding(
               mesh, PartitionSpec("data", "model")))}
    ctx = ShardCtx(mesh=mesh, rules={"batch": "data"}, data_slot=1,
                   device=mesh.devices[1, 0], rows=(2, 4))
    view, close = open_cache(seq, ctx, {"k": 2, "pos": 1})
    assert isinstance(view["k"], SeqShards) and view["k"].length == 8
    assert [(lo, hi) for lo, hi, _, _ in view["k"].parts] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    view["k"].parts[2][2].fill_(7.0)  # written in place, in its piece
    close()
    assert (gather(seq["k"], "cpu")[2:4, :, 4:6] == 7.0).all()
    heads = {"k": device_put(k, NamedSharding(  # its 2 heads over model
        make_mesh((2, 2), ("data", "model"), devices=DISTINCT[:4]),
        PartitionSpec("data", "model")))}
    ctx.mesh = heads["k"].mesh
    ctx.device = heads["k"].mesh.devices[1, 0]
    view, close = open_cache(heads, ctx, {"k": 2})
    assert torch.is_tensor(view["k"]) and torch.equal(view["k"], k[2:4])
    view["k"].fill_(-1.0)
    close()
    got = gather(heads["k"], "cpu")
    assert (got[2:4] == -1.0).all() and torch.equal(got[:2], k[:2])


def _partial(q, k, v, valid):
    """One online-softmax partial over keys ``k`` (some masked)."""
    s = torch.where(valid, q @ k.T, NEG)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[:, None]), 0.0)
    return m, p.sum(dim=-1), p @ v


@pytest.mark.parametrize("empty", ["floor", "-inf", "none"])
def test_combine_partials_with_an_empty_piece(empty):
    """Pieces of a split key set merged by log-sum-exp equal one softmax
    over all valid keys; a piece with no valid key (its max the masked
    floor, or −inf) adds nothing and makes no NaN."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((3, 5)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((12, 5)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((12, 4)), dtype=torch.float32)
    valid = torch.ones(3, 12, dtype=torch.bool)
    if empty != "none":
        valid[:, 4:8] = False  # the middle piece holds no valid key
    want = torch.softmax(torch.where(valid, q @ k.T, NEG), dim=-1) @ v
    parts = [_partial(q, k[i:i + 4], v[i:i + 4], valid[:, i:i + 4])
             for i in (0, 4, 8)]
    if empty == "-inf":
        parts[1] = (torch.full((3,), -torch.inf), torch.zeros(3),
                    torch.zeros(3, 4))
    got = combine_partials(parts)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    none = combine_partials([(torch.full((3,), -torch.inf), torch.zeros(3),
                              torch.zeros(3, 4))] * 2)
    assert torch.equal(none, torch.zeros(3, 4))


def test_make_mesh_needs_a_gpu_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"), devices=["cuda"])
    with pytest.raises(ValueError, match="mix"):
        make_mesh((2, 1), ("data", "model"), devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="needs 8"):
        make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 4)
    mesh = make_mesh((2, 4), ("data", "model"), devices=SAME)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8


def test_production_and_test_meshes():
    m1 = make_production_mesh()
    m2 = make_production_mesh(multi_pod=True)
    assert m1.shape == {"data": 16, "model": 16}
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert m1.size == 256 and m2.size == 512
    assert {d.type for d in m2.devices.flat} == {"meta"}
    t = make_test_mesh()
    assert t.shape == {"data": 2, "model": 2}
    t = make_test_mesh(4, 2, devices=SAME)
    assert t.devices[3, 1] == torch.device("cpu")

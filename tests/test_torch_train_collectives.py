"""The port's int8-compressed data-parallel all-reduce against `repro`'s
on 8 forced host devices (its `shard_map` over a mesh; the port's list
of 8 CPU slots): `compressed_psum` and `make_compressed_dp_grad_fn` give
the reference's numbers, within its own bounds of the exact mean (0.02)
and of the exact gradient (0.05)."""
import os

import numpy as np
import pytest
import torch

from _subproc import run_py
from repro_torch.distributed import (compressed_psum, compressed_psum_tree,
                                     make_compressed_dp_grad_fn)

SLOTS = ["cpu"] * 8


def _rows():
    return np.random.default_rng(0).standard_normal((8, 64)) \
        .astype(np.float32)


def _linear_problem():
    w = np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal((32, 4)).astype(np.float32)
    return w, x, y


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """`repro`'s compressed mean of `_rows` and its compressed DP grads
    of `_linear_problem`, from a process with 8 host devices."""
    d = str(tmp_path_factory.mktemp("ref_collectives"))
    run_py(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import (compressed_psum, get_shard_map,
                                           make_compressed_dp_grad_fn)
mesh = jax.make_mesh((8,), ("data",))
g = jnp.asarray(np.random.default_rng(0).standard_normal((8, 64)),
                jnp.float32)
y = get_shard_map()(lambda x: compressed_psum(x, "data"), mesh=mesh,
                    in_specs=P("data"), out_specs=P("data"))(g)
np.save({d!r} + "/psum.npy", np.asarray(y))
W = jnp.asarray(np.random.default_rng(1).standard_normal((16, 4)), jnp.float32)
x = jnp.asarray(np.random.default_rng(2).standard_normal((32, 16)), jnp.float32)
t = jnp.asarray(np.random.default_rng(3).standard_normal((32, 4)), jnp.float32)
def loss(w, batch):
    xx, yy = batch
    return jnp.mean((xx @ w - yy) ** 2)
l, gw = make_compressed_dp_grad_fn(loss, mesh, "data")(W, (x, t))
np.save({d!r} + "/dp_loss.npy", np.asarray(l))
np.save({d!r} + "/dp_grad.npy", np.asarray(gw))
""", devices=8)
    return {n: np.load(os.path.join(d, f"{n}.npy"))
            for n in ("psum", "dp_loss", "dp_grad")}


def test_compressed_psum_matches_the_reference(reference):
    g = _rows()
    got = compressed_psum([torch.tensor(r) for r in g])
    assert len(got) == 8
    got = torch.stack(got).numpy()
    np.testing.assert_allclose(got, reference["psum"], rtol=1e-6, atol=1e-7)
    expect = np.broadcast_to(g.mean(axis=0, keepdims=True), (8, 64))
    rel = np.abs(got - expect).max() / (np.abs(expect).max() + 1e-9)
    assert rel < 0.02, rel  # int8 quantization error bound


def test_compressed_dp_grads_match_the_reference(reference):
    w, x, y = _linear_problem()

    def loss(w, batch):
        xx, yy = batch
        return torch.mean((xx @ w - yy) ** 2)

    f = make_compressed_dp_grad_fn(loss, SLOTS)
    l1, g1 = f(torch.tensor(w), (torch.tensor(x), torch.tensor(y)))
    np.testing.assert_allclose(l1.item(), reference["dp_loss"], rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), reference["dp_grad"], rtol=1e-5,
                               atol=1e-6)
    wt = torch.tensor(w, requires_grad=True)
    exact, = torch.autograd.grad(loss(wt, (torch.tensor(x),
                                           torch.tensor(y))), wt)
    rel = float((g1 - exact).abs().max() / (exact.abs().max() + 1e-9))
    assert rel < 0.05, rel
    with pytest.raises(ValueError, match="split"):
        f(torch.tensor(w), (torch.tensor(x[:30]), torch.tensor(y[:30])))


def test_compressed_psum_tree_and_stochastic_rounding():
    """A tree a slot reduces leaf by leaf; stochastic rounding keeps the
    same bound; an all-zero tensor stays zero."""
    rng = np.random.default_rng(4)
    trees = [{"a": torch.tensor(rng.standard_normal((5, 3)),
                                dtype=torch.float32),
              "b": [torch.zeros(4)]} for _ in range(4)]
    out = compressed_psum_tree(trees)
    assert len(out) == 4 and torch.equal(out[0]["b"][0], torch.zeros(4))
    mean = torch.stack([t["a"] for t in trees]).mean(0)
    # each slot rounds to within half the shared scale (stochastic: one)
    scale = max(float(t["a"].abs().max()) for t in trees) / 127
    for o in out:
        assert float((o["a"] - mean).abs().max()) <= scale / 2 + 1e-6
    gen = torch.Generator().manual_seed(0)
    sr = compressed_psum([t["a"] for t in trees], generator=gen)
    assert float((sr[0] - mean).abs().max()) <= scale + 1e-6
    assert not torch.equal(sr[0], out[0]["a"])

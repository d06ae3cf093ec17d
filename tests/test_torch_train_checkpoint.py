"""The port's checkpoints: atomic keep-k steps in `repro`'s on-disk
format, so a checkpoint either package writes restores in the other —
the gathered layout both ways, the reference's per-shard layout (written
on 8 forced host devices) into the port, and bfloat16 leaves as the
reference writes them (raw 2-byte words under ``'<V2'``)."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _subproc import run_py
from repro_torch.checkpoint import (all_steps, latest_step,
                                    restore_checkpoint, save_checkpoint)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": {"c": rng.integers(0, 100, (4,)).astype(np.int32),
                  "d": np.float32(rng.standard_normal())}}


def _port(arrays):
    if isinstance(arrays, dict):
        return {k: _port(v) for k, v in arrays.items()}
    return torch.tensor(np.asarray(arrays))


def _ref(arrays):
    return jax.tree_util.tree_map(jnp.asarray, arrays)


def _same(port_tree, arrays):
    if isinstance(arrays, dict):
        return all(_same(port_tree[k], v) for k, v in arrays.items())
    a = np.asarray(arrays)
    return port_tree.dtype == torch.from_numpy(a).dtype and np.array_equal(
        port_tree.numpy(), a)


def test_roundtrip_and_keep_k(tmp_path):
    root = str(tmp_path)
    trees = {}
    for s in (1, 2, 3, 4, 5):
        trees[s] = _arrays(s)
        save_checkpoint(root, s, _port(trees[s]), keep=3)
    assert all_steps(root) == [3, 4, 5]
    assert latest_step(root) == 5
    restored, step = restore_checkpoint(root, _port(_arrays()))
    assert step == 5 and _same(restored, trees[5])
    restored, step = restore_checkpoint(root, _port(_arrays()), step=4)
    assert step == 4 and _same(restored, trees[4])


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _port(_arrays()))
    os.makedirs(os.path.join(root, "step_000000002.tmp"))
    assert all_steps(root) == [1]  # uncommitted write is invisible
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _port(_arrays()))


def test_the_reference_writes_and_the_port_restores(tmp_path):
    from repro.checkpoint import save_checkpoint as r_save

    arrays = _arrays(7)
    r_save(str(tmp_path), 3, _ref(arrays))
    got, step = restore_checkpoint(str(tmp_path), _port(_arrays()))
    assert step == 3 and _same(got, arrays)


def test_the_port_writes_and_the_reference_restores(tmp_path):
    from repro.checkpoint import restore_checkpoint as r_restore
    from repro.checkpoint import save_checkpoint as r_save

    arrays = _arrays(8)
    save_checkpoint(str(tmp_path / "port"), 3, _port(arrays))
    got, step = r_restore(str(tmp_path / "port"), _ref(_arrays()))
    assert step == 3
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_ref(arrays))):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x),
                                                     np.asarray(y))
    # byte for byte the files and the manifest the reference writes
    r_save(str(tmp_path / "ref"), 3, _ref(arrays))
    pdir, rdir = (tmp_path / d / "step_000000003" for d in ("port", "ref"))
    names = sorted(os.listdir(rdir))
    assert sorted(os.listdir(pdir)) == names
    assert "b__c.npy" in names and "manifest.json" in names
    for n in names:
        assert (pdir / n).read_bytes() == (rdir / n).read_bytes(), n


def test_a_train_state_keeps_the_reference_file_names(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.nn import init_params, model_decls
    from repro_torch.training import train_state_init

    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=64)
    params = init_params(model_decls(cfg), torch.Generator(), device="cpu")
    state = train_state_init(params, cfg)
    d = save_checkpoint(str(tmp_path), 0, state)
    names = set(os.listdir(d))
    assert {"params__stage0__slot0__ffn__down.npy", "step.npy",
            "opt__m__embed__table.npy", "opt__v__final_norm__scale.npy"} \
        <= names
    back, _ = restore_checkpoint(str(tmp_path), state)
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 0


def test_the_reference_per_shard_layout_restores_in_the_port(tmp_path):
    """``sharded=True`` on 8 forced host devices: each leaf as its
    shards' files and index ranges (one leaf sharded over rows, one over
    columns, one replicated), assembled by the port."""
    d = str(tmp_path)
    out = run_py(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import save_checkpoint
mesh = jax.make_mesh((8,), ("data",))
x = jnp.arange(64 * 6, dtype=jnp.float32).reshape(64, 6)
y = jnp.arange(3 * 16, dtype=jnp.int32).reshape(3, 16)
z = jnp.arange(5, dtype=jnp.float32)
tree = {{"x": jax.device_put(x, NamedSharding(mesh, P("data", None))),
        "y": jax.device_put(y, NamedSharding(mesh, P(None, "data"))),
        "z": jax.device_put(z, NamedSharding(mesh, P()))}}
save_checkpoint({d!r}, 7, tree, sharded=True)
print("SAVED")
""", devices=8)
    assert "SAVED" in out
    assert os.path.exists(os.path.join(d, "step_000000007",
                                       "x.shard7.npy"))
    like = {"x": torch.empty((64, 6), device="meta"),
            "y": torch.empty((3, 16), dtype=torch.int32, device="meta"),
            "z": torch.empty((5,), device="meta")}
    got, step = restore_checkpoint(d, like, device="cpu")
    assert step == 7
    np.testing.assert_array_equal(
        got["x"].numpy(), np.arange(64 * 6, dtype=np.float32).reshape(64, 6))
    np.testing.assert_array_equal(
        got["y"].numpy(), np.arange(48, dtype=np.int32).reshape(3, 16))
    np.testing.assert_array_equal(got["z"].numpy(),
                                  np.arange(5, dtype=np.float32))
    with pytest.raises(ValueError, match="meta"):
        restore_checkpoint(d, like)


def test_bf16_leaves_have_the_reference_bytes_and_round_trip(tmp_path):
    from repro.checkpoint import save_checkpoint as r_save

    w = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    r_save(str(tmp_path / "ref"), 1, {"w": jnp.asarray(w, jnp.bfloat16)})
    t = torch.tensor(w).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "port"), 1, {"w": t})
    files = [tmp_path / d / "step_000000001" / "w.npy"
             for d in ("port", "ref")]
    assert files[0].read_bytes() == files[1].read_bytes()
    assert np.load(files[0]).dtype == np.dtype("V2")
    for d in ("port", "ref"):
        got, _ = restore_checkpoint(str(tmp_path / d),
                                    {"w": torch.zeros((4, 3),
                                                      dtype=torch.bfloat16)})
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    np.testing.assert_array_equal(
        got["w"].float().numpy(),
        w.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError, match="bfloat16"):
        restore_checkpoint(str(tmp_path / "port"), {"w": torch.zeros((4, 3))})


def test_the_reference_per_shard_bf16_layout_restores(tmp_path):
    d = str(tmp_path)
    out = run_py(f"""
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import save_checkpoint
mesh = jax.make_mesh((4,), ("data",))
w = (jnp.arange(32, dtype=jnp.float32).reshape(8, 4) / 7).astype(jnp.bfloat16)
save_checkpoint({d!r}, 2, {{"w": jax.device_put(
    w, NamedSharding(mesh, P("data", None)))}}, sharded=True)
print("SAVED")
""", devices=4)
    assert "SAVED" in out
    got, _ = restore_checkpoint(d, {"w": torch.empty((8, 4),
                                                     dtype=torch.bfloat16,
                                                     device="meta")},
                                device="cpu")
    want = (torch.arange(32, dtype=torch.float32).reshape(8, 4) / 7) \
        .to(torch.bfloat16)
    assert torch.equal(got["w"], want)


def test_a_shape_mismatch_is_refused(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros((3, 2))})

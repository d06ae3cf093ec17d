"""The port's token pipeline against `repro`'s: the same arrays, byte for
byte, for every seed, step, distribution and shard."""
import numpy as np
import pytest

from repro.data import DataConfig as RConfig
from repro.data import TokenPipeline as RPipeline
from repro_torch.data import DataConfig, TokenPipeline


@pytest.mark.parametrize("kind", ["markov", "uniform"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 11), (7, 1000)])
def test_global_batches_equal_the_reference(kind, seed, step):
    args = dict(vocab_size=128, global_batch=8, seq_len=32, seed=seed,
                kind=kind)
    got = TokenPipeline(DataConfig(**args)).global_batch_at(step)
    want = RPipeline(RConfig(**args)).global_batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_shards_equal_the_reference_and_tile_the_batch():
    args = dict(vocab_size=100, global_batch=8, seq_len=16, seed=3)
    pipe, ref = TokenPipeline(DataConfig(**args)), RPipeline(RConfig(**args))
    shards = [pipe.shard_batch_at(11, i, 4) for i in range(4)]
    for i, sh in enumerate(shards):
        want = ref.shard_batch_at(11, i, 4)
        for k in want:
            np.testing.assert_array_equal(sh[k], want[k])
    np.testing.assert_array_equal(
        np.concatenate([s["tokens"] for s in shards]),
        pipe.global_batch_at(11)["tokens"])
    with pytest.raises(ValueError, match="not divisible"):
        pipe.shard_batch_at(0, 0, 3)


def test_markov_batches_follow_the_affine_map_off_the_noise():
    pipe = TokenPipeline(DataConfig(97, 4, 64, seed=5, noise=0.1))
    b = pipe.global_batch_at(2)
    nxt = (b["tokens"].astype(np.int64) * pipe._a + pipe._c) % 97
    assert 0.8 < (nxt == b["labels"]).mean() <= 1.0
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

"""The port's pulse-code (CSD-P) path against the reference's, on the CPU.

Same numpy inputs through `repro` and `repro_torch`: the quantizer's codes,
exponents and decoded weights must be bit-identical; the port's matmul
(its plain version here) is held to the reference's own bound,
max|y − y_ref| / max|y_ref| < 1e-5 (`tests/test_kernels.py`), against the
reference's Pallas kernel in interpret mode and against ``x @
pulse_dequantize``; `quantize_param_tree` must quantize the same leaves to
the same values.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.csd import csd_digits as ref_csd_digits
from repro.core.csd import csd_truncate as ref_csd_truncate
from repro.core.serve_quant import quantize_param_tree as ref_quantize_tree
from repro.kernels import pulse_dequantize as ref_dequantize
from repro.kernels import pulse_matmul_op as ref_matmul_op
from repro.kernels import pulse_quantize as ref_quantize
from repro.kernels.ref import pulse_decode_ref as ref_decode
from repro.nn import init_params, model_decls
from repro_torch.core.csd import csd_digits_tensor, csd_truncate_tensor
from repro_torch.core.serve_quant import quantize_param_tree, tensors_from_arrays
from repro_torch.kernels import pulse_dequantize, pulse_matmul_op, pulse_quantize
from repro_torch.kernels.ref import pulse_decode_ref

bm = importlib.import_module("repro_torch.kernels.blmac_matmul")
CPU = "cpu"
GRID = [(128, 128, 8), (512, 256, 16), (256, 384, 4)]  # (K, N, M)


def _weights(planes, k, n):
    """The reference test's draw (`tests/test_kernels.py`)."""
    rng = np.random.default_rng(planes * k + n)
    w = rng.standard_normal((k, n)) * np.exp2(rng.integers(-8, 8, (k, n)))
    return rng, w


def _edge_weights():
    """Exact powers of two, their next floats up, sign flips and 1.5×, in
    row 0 of a group whose other rows are small; an all-zero group; a
    group of 2**-130 (below the int8 exponent clip).  Float64: a float32
    cast would round the next floats of 2**k back to 2**k."""
    vals = []
    for k in (2, 5, -7, 20, 0, -126, -127, -130, -149):
        b = 2.0 ** k
        up = np.nextafter(b, np.inf)
        vals += [b, up, np.nextafter(up, np.inf), -b, 1.5 * b]
    vals = np.array(vals)
    w = np.zeros((64, len(vals) + 3))
    w[0, :len(vals)] = vals
    w[5, :len(vals)] = 0.3 * vals
    w[:, -1] = 2.0 ** -130
    w[32:, -2] = 1e-3  # rows 0..31 of this column: an all-zero group
    return w


def _assert_same_quantization(w, planes):
    codes, ge = ref_quantize(w, planes)
    tc, tg = pulse_quantize(w, planes, device=CPU)
    assert tc.dtype == torch.uint8 and tg.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), codes)
    np.testing.assert_array_equal(tg.numpy(), ge)
    wd = ref_dequantize(codes, ge)
    td = pulse_dequantize(tc, tg)
    assert td.dtype == torch.float64
    np.testing.assert_array_equal(td.numpy(), wd)
    # the float32 decode is exact: the float64 decode, rounded nowhere
    np.testing.assert_array_equal(pulse_decode_ref(tc, tg).numpy(),
                                  wd.astype(np.float32))
    assert np.array_equal(wd.astype(np.float32).astype(np.float64), wd)
    return codes, ge, wd


@pytest.mark.parametrize("planes", [1, 2, 4])
@pytest.mark.parametrize("k,n,m", GRID)
def test_pulse_quantize_matches_reference(planes, k, n, m):
    _, w = _weights(planes, k, n)
    codes, ge, _ = _assert_same_quantization(w, planes)
    # the reference's jnp decode oracle, exactly, on the reference's grid
    want = np.asarray(ref_decode(jnp.asarray(codes), jnp.asarray(ge)))
    got = pulse_decode_ref(torch.from_numpy(codes), torch.from_numpy(ge))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_pulse_quantize_edge_values(planes):
    w = _edge_weights()
    codes, ge, wd = _assert_same_quantization(w, planes)
    assert ge[0, -2] == -127 and (codes[:, :32, -2] == bm.NULL_POS).all()
    # the exponent is clipped after the pulses were taken: 2**-130 comes
    # back as 2**-127, in the reference and the port alike
    assert wd[0, -1] == 2.0 ** -127
    # numpy's log2 rounds nextafter(2**5) down to 5, nextafter(4) up to 3
    col = {v: i for i, v in enumerate(w[0])}
    assert ge[0, col[np.nextafter(32.0, np.inf)]] == 5
    assert ge[0, col[np.nextafter(4.0, np.inf)]] == 3


def test_quantizer_column_chunks_do_not_change_codes(monkeypatch):
    _, w = _weights(4, 256, 384)
    whole = pulse_quantize(w, 4, device=CPU)
    monkeypatch.setattr(bm, "QUANT_CHUNK", 256 * 7)  # 7 columns per chunk
    chunked = pulse_quantize(w, 4, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


@pytest.mark.parametrize("planes", [1, 2, 4])
@pytest.mark.parametrize("k,n,m", GRID)
def test_pulse_matmul_matches_reference(planes, k, n, m):
    rng, w = _weights(planes, k, n)
    codes, ge = ref_quantize(w, planes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y_ref = x @ ref_dequantize(codes, ge)
    y_pallas = np.asarray(ref_matmul_op(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(ge), planes,
        bm=max(1, m // 2), bk=128, bn=128))
    y = pulse_matmul_op(x, codes, ge, planes, device=CPU)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    scale = np.abs(y_ref).max() + 1e-9
    assert np.abs(y.numpy() - y_ref).max() / scale < 1e-5
    assert np.abs(y.numpy() - y_pallas).max() / scale < 1e-5


def test_pulse_matmul_reads_the_first_planes():
    rng, w = _weights(4, 128, 128)
    codes, ge = ref_quantize(w, 4)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    y = pulse_matmul_op(x, codes, ge, 2, device=CPU)
    y2 = pulse_matmul_op(x, codes[:2], ge, 2, device=CPU)
    assert torch.equal(y, y2)
    y_pallas = np.asarray(ref_matmul_op(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(ge), 2,
        bm=8, bk=128, bn=128))
    scale = np.abs(y_pallas).max()
    assert np.abs(y.numpy() - y_pallas).max() / scale < 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pulse_matmul_casts_half_inputs_to_float32(dtype):
    rng, w = _weights(2, 128, 128)
    codes, ge = pulse_quantize(w, 2, device=CPU)
    x = torch.as_tensor(rng.standard_normal((4, 128))).to(dtype)
    y = pulse_matmul_op(x, codes, ge, 2, device=CPU)
    assert y.dtype == torch.float32
    assert torch.equal(y, pulse_matmul_op(x.float(), codes, ge, 2, device=CPU))


def test_k_not_a_multiple_of_group_raises():
    w = np.ones((48, 8))
    with pytest.raises(ValueError):
        ref_quantize(w, 2)
    with pytest.raises(ValueError):
        pulse_quantize(w, 2, device=CPU)
    codes = np.full((2, 48, 8), bm.NULL_POS, np.uint8)
    with pytest.raises(ValueError):
        pulse_matmul_op(np.ones((4, 48), np.float32), codes,
                        np.zeros((1, 8), np.int8), 2, device=CPU)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.int64])
def test_csd_tensor_codec_matches_reference(dtype):
    rng = np.random.default_rng(7)
    w = rng.integers(-(1 << 14), (1 << 14) + 1, (40, 50)).astype(dtype)
    t = torch.from_numpy(w)
    np.testing.assert_array_equal(csd_digits_tensor(t, 16).numpy(),
                                  ref_csd_digits(w, 16))
    np.testing.assert_array_equal(csd_digits_tensor(t).numpy(),
                                  ref_csd_digits(w))
    for planes in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(
            csd_truncate_tensor(t, planes, 16).numpy(),
            ref_csd_truncate(w, planes, n_digits=16))
    with pytest.raises(ValueError):
        csd_digits_tensor(t, 4)


def test_launch_plan_covers_k_and_fills_the_card():
    for m, n, k in [(4, 2048, 11008), (128, 2048, 11008), (4, 256, 2048),
                    (128, 11008, 2048), (1, 5, 32), (40, 300, 96)]:
        bm_rows, per, splits = bm.launch_plan(m, n, k, 132)
        steps = -(-k // bm.BK)
        assert bm_rows >= min(m, 128) and bm_rows in (16, 64, 128)
        assert (splits - 1) * per < steps <= splits * per
        assert splits == 1 or per >= bm.MIN_SPLIT_STEPS
    assert bm.launch_plan(4, 2048, 11008, 132)[2] > 1  # decode splits K


def _flat_arrays(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in flat}


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_quantize_param_tree_matches_reference(planes):
    cfg = get_config("qwen2.5-3b").reduced(n_layers=2, vocab_size=256)
    params = init_params(model_decls(cfg), jax.random.key(0))
    arrays = _flat_arrays(params)
    state = tensors_from_arrays(arrays, device=CPU)
    assert all(np.array_equal(state[k].numpy(), a) for k, a in arrays.items())
    ref_tree, ref_stats = ref_quantize_tree(params, planes)
    got, stats = quantize_param_tree(state, planes, device=CPU)
    want = _flat_arrays(ref_tree)
    assert list(got) == list(want)
    for name, a in want.items():
        assert got[name].dtype == state[name].dtype
        np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)
    assert stats["n_quantized"] == ref_stats["n_quantized"] == 5
    changed = {k for k in want if not np.array_equal(want[k], arrays[k])}
    assert "stage0/slot0/mixer/wq" not in changed  # head axis: left alone
    assert "stage0/slot0/mixer/wo" in changed
    assert set(stats) == set(ref_stats)
    for key in ("bits_per_weight", "bits_per_weight_achievable"):
        assert stats[key] == ref_stats[key]
    assert stats["mean_rel_err"] == pytest.approx(ref_stats["mean_rel_err"],
                                                  rel=1e-9)

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


# the (M, N, K) of every launch of one qwen2.5-3b layer (d_model 2,048, 16
# heads x 128, 2 KV heads, d_ff 11,008) at decode and prefill, then edges:
# one row, tile edges in M, N below and off the 128-column tile, K of one
# group and one step
QWEN_LAUNCHES = [(m, n, k) for m in (4, 128)
                 for k, n in ((2048, 2048), (2048, 256), (2048, 256),
                              (2048, 2048), (2048, 11008), (2048, 11008),
                              (11008, 2048))]
EDGE_LAUNCHES = [(1, 5, 32), (40, 300, 96), (17, 100, 4096), (130, 2048, 2048),
                 (1, 2048, 11008), (8, 200, 64), (16, 129, 8192),
                 (64, 127, 2048), (65, 4096, 512), (200, 11008, 2048),
                 (128, 1, 11008), (3, 64, 64)]


@pytest.mark.parametrize("planes,group", [(4, 32), (1, 16), (8, 64), (2, 1)])
def test_launch_plan_covers_k_and_fills_the_card(planes, group):
    """The plan's blocks cover K with no empty split and every row of M (a
    wgmma tile above 16 rows, where one fits; the swapped 16-row tile
    otherwise serves any M), its ring of at least three stages fits in
    shared memory, a split wgmma tile keeps its last block's sum within
    `SUM_ROWS_PER_STEP`, and a decode-sized M splits K until every SM has
    a block; at every launch of a qwen2.5-3b layer and at the edges."""
    for m, n, k in QWEN_LAUNCHES + EDGE_LAUNCHES:
        k = -(-k // group) * group  # K is a multiple of the group
        plan = bm.launch_plan(m, n, k, 132, planes, group)
        steps = -(-k // bm.BK)
        assert plan.bm in (8, 16, 64, 128)
        wgmma_fits = bm.smem_bytes(64, planes, group,
                                   bm.MIN_STAGES) <= bm.smem_limit(1)
        if m <= 16:
            assert plan.bm == (8 if m <= 8 else 16)
        elif wgmma_fits:
            assert plan.bm in (64, 128) and (m > 64 or plan.bm == 64)
        else:
            assert plan.bm == 16
        if plan.bm > 16 and plan.splits > 1:
            assert (plan.splits * min(plan.bm, m)
                    <= bm.SUM_ROWS_PER_STEP * plan.per)
        assert bm.MIN_STAGES <= plan.stages <= bm.MAX_STAGES
        assert bm.smem_bytes(plan.bm, planes, group, plan.stages) \
            <= bm.smem_limit(plan.blocks_per_sm)
        assert (plan.splits - 1) * plan.per < steps <= plan.splits * plan.per
        assert 1 <= plan.splits <= bm.MAX_SPLITS
        assert plan.splits == 1 or plan.per >= bm.MIN_SPLIT_STEPS
        assert plan.blocks == (plan.splits * -(-n // bm.BN)
                               * -(-m // plan.bm))
    decode = bm.launch_plan(4, 2048, 11008, 132, planes, group)
    assert decode.bm == 8 and decode.splits > 1 and decode.blocks >= 132


# the shapes of `tests/test_torch_cuda.py`'s
# `test_pulse_matmul_kernel_matches_plain` (K, N, M), which holds every
# plan against the plain version on the card
CARD_PLAN_CASES = [(128, 128, 8), (512, 256, 16), (256, 384, 4),
                   (256, 200, 37), (2048, 136, 130)] + [
    (k, 200, m) for m in (1, 4, 8, 16, 17, 64, 128, 200) for k in (32, 8192)
] + [(64, 11000, 128), (64, 11000, 200), (4096, 1000, 128), (4096, 1000, 200)]


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_launch_plan_reaches_every_tile(planes):
    """On a 132-SM card the card test's shapes reach every tile the plan
    can choose (8, 16, 64 and 128 rows), each with one split of K and with
    many, and a small N at prefill takes the 64-row tile (more blocks,
    half the partial tile)."""
    seen = {(p.bm, p.splits > 1) for p in (
        bm.launch_plan(m, n, k, 132, planes) for k, n, m in CARD_PLAN_CASES)}
    assert seen == {(t, many) for t in (8, 16, 64, 128)
                    for many in (False, True)}
    assert bm.launch_plan(128, 256, 2048, 132, planes).bm == 64
    assert bm.launch_plan(128, 11008, 2048, 132, planes).bm == 128


def test_launch_plan_model_prefers_fewer_waves():
    """The plan's choices at the layer's big launches: `gate` at M = 128
    splits K so that its 86 column tiles fill two waves of 132 SMs, and
    `down` at M = 128 fills one; a split is never chosen when it adds
    nothing (K of one step)."""
    gate = bm.launch_plan(128, 11008, 2048, 132)
    assert gate.bm == 128 and gate.blocks <= 2 * 132 < gate.blocks + 86
    down = bm.launch_plan(128, 2048, 11008, 132)
    assert down.bm == 128 and down.blocks <= 132 < down.blocks + 16
    assert bm.launch_plan(4, 2048, 32, 132).splits == 1


# the plan of each distinct launch of a qwen2.5-3b layer, (M, N, K) →
# (tile, stages, steps a split walks, splits, blocks), as `chip_smoke.py`
# runs them on a 132-SM H100 and PERF.md records their times; pinned, so
# that a change of the rule shows here first
MEASURED_PLANS = {
    (4, 2048, 2048): (8, 3, 4, 16, 256),
    (4, 256, 2048): (8, 3, 2, 32, 64),
    (4, 11008, 2048): (8, 3, 22, 3, 258),
    (4, 2048, 11008): (8, 3, 22, 16, 256),
    (128, 2048, 2048): (128, 4, 8, 8, 128),
    (128, 256, 2048): (64, 6, 4, 16, 64),
    (128, 11008, 2048): (128, 4, 22, 3, 258),
    (128, 2048, 11008): (128, 4, 43, 8, 128),
}


@pytest.mark.parametrize("m,n,k", sorted(MEASURED_PLANS))
def test_launch_plan_picks_the_measured_plans(m, n, k):
    """At every launch of a qwen2.5-3b layer at P = 4 on 132 SMs the plan
    is the recorded one: the 64-row tile for `wk`/`wv` at prefill, and
    one wave of blocks but at `gate`/`up`, which fill two."""
    plan = bm.launch_plan(m, n, k, 132)
    assert (plan.bm, plan.stages, plan.per, plan.splits,
            plan.blocks) == MEASURED_PLANS[(m, n, k)]


def test_launch_plan_fits_every_plane_count():
    """Up to 16 planes every M has a tile whose ring of at least three
    stages fits in shared memory: at many planes the large tiles give way
    to the swapped 16-row tile, which serves any M."""
    for planes in (1, 4, 8, 12, 16):
        for m in (1, 16, 17, 64, 65, 200):
            plan = bm.launch_plan(m, 2048, 2048, 132, planes)
            assert plan.stages >= bm.MIN_STAGES
            assert bm.smem_bytes(plan.bm, planes, bm.GROUP, plan.stages) \
                <= bm.smem_limit(plan.blocks_per_sm)
    assert bm.launch_plan(200, 2048, 2048, 132, 16).bm == 16


def _rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: keep 10 mantissa bits, rounding
    ties away from zero, by integer operations on the bit pattern (adding
    half an ulp of TF32 to the magnitude bits, then clearing 13 bits)."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = ((b + 0x1000) & 0xFFFFE000).to(torch.uint32)
    return b.view(torch.int32).view(torch.float32)


def _matmul_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: x and W split into TF32 hi
    and lo parts, ``x_hi w_lo + x_lo w_hi + x_hi w_hi`` per 32-row step of
    K (each product exact in float64), each step added to a float32 sum."""
    x_hi = _rna_tf32(x)
    x_lo = _rna_tf32(x - x_hi)
    w_hi = _rna_tf32(w)
    w_lo = w - w_hi
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], bm.BK):
        ks = slice(k0, k0 + bm.BK)
        step = (x_hi[:, ks].double() @ w_lo[ks].double()
                + x_lo[:, ks].double() @ w_hi[ks].double()
                + x_hi[:, ks].double() @ w_hi[ks].double())
        y += step.float()
    return y


@pytest.mark.parametrize("planes", [1, 2, 4])
@pytest.mark.parametrize("k,n,m", GRID)
def test_3xtf32_split_meets_the_reference_bound(planes, k, n, m):
    """The split's numerics on the reference grid: every decoded weight is
    w_hi + w_lo exactly with w_lo already a TF32 value; the three-term
    product is within 1e-5 of `repro`'s Pallas kernel (interpret mode) and
    of float64; with x = I it gives the plain decode bit for bit."""
    rng, w = _weights(planes, k, n)
    codes, ge = ref_quantize(w, planes)
    wd = pulse_decode_ref(torch.from_numpy(codes), torch.from_numpy(ge))
    w_hi = _rna_tf32(wd)
    assert torch.equal(w_hi + (wd - w_hi), wd)
    assert torch.equal(_rna_tf32(wd - w_hi), wd - w_hi)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = _matmul_3xtf32(torch.from_numpy(x), wd)
    y64 = x.astype(np.float64) @ ref_dequantize(codes, ge)
    y_pallas = np.asarray(ref_matmul_op(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(ge), planes,
        bm=max(1, m // 2), bk=128, bn=128))
    scale = np.abs(y64).max()
    assert np.abs(y.numpy() - y64).max() / scale < 1e-5
    assert np.abs(y.numpy() - y_pallas).max() / scale < 1e-5
    assert torch.equal(_matmul_3xtf32(torch.eye(k), wd), wd)


def test_rna_tf32_rounds_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 2.0 ** -130, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         2.0 ** -130, 0.0], dtype=torch.float32)
    assert torch.equal(_rna_tf32(v), want)


def _toward_zero_f32(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` to float32, rounded toward zero: how the tensor cores
    add into their accumulator (they truncate)."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def test_3xtf32_split_holds_the_bound_at_full_span():
    """`down`'s K = 11,008 with every weight spanning the full 16 bits of
    its pulses (±2^15 ± 2^10 ± 2^5 ± 2^0, times its group's 2^(e − 14)).
    The kernel's arithmetic, emulated in float64: per 32-row step a fresh
    accumulator takes, per 8-row chunk, x_hi w_lo, x_lo w_hi and x_hi w_hi
    (each chunk's dot products exact, each addition truncated to float32);
    the step is then added, rounded to nearest, to the float32 sum.  It
    stays within 1e-5 of float64; one TF32 pass does not."""
    k, n, m = 11008, 64, 4
    rng = np.random.default_rng(k)
    negative = rng.random((4, k, n)) < 0.5
    codes = torch.from_numpy(
        (0x80 | (negative * 0x40)
         | np.array([15, 10, 5, 0])[:, None, None]).astype(np.uint8))
    ge = torch.from_numpy(rng.integers(-8, 4, (k // bm.GROUP, n))
                          .astype(np.int8))
    w = pulse_decode_ref(codes, ge)
    q = torch.from_numpy(np.where(negative, -1.0, 1.0)
                         * np.exp2([15, 10, 5, 0])[:, None, None]).sum(0)
    scale = torch.exp2(ge.double() - 14).repeat_interleave(bm.GROUP, dim=0)
    assert torch.equal(w.double(), q * scale)  # every weight spans 16 bits
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    x_hi = _rna_tf32(x)
    x_lo = _rna_tf32(x - x_hi)
    w_hi = _rna_tf32(w)
    w_lo = w - w_hi
    assert torch.equal(_rna_tf32(w_lo), w_lo)  # w = w_hi + w_lo, both TF32

    def chunks(a, b):  # (chunk, m, n): each 8-row chunk's exact products
        return torch.einsum("mci,cin->cmn", a.double().reshape(m, -1, 8),
                            b.double().reshape(-1, 8, n))

    terms = (chunks(x_hi, w_lo), chunks(x_lo, w_hi), chunks(x_hi, w_hi))
    y = torch.zeros((m, n), dtype=torch.float32)
    per_step = bm.BK // 8
    for c0 in range(0, k // 8, per_step):
        part = torch.zeros((m, n), dtype=torch.float32)
        for c in range(c0, c0 + per_step):
            for t in terms:
                part = _toward_zero_f32(part.double() + t[c])
        y += part
    y64 = x.double() @ w.double()
    scale_y = y64.abs().max()
    assert (y.double() - y64).abs().max() / scale_y < 1e-5
    one_pass = x_hi.double() @ w_hi.double()
    assert (one_pass - y64).abs().max() / scale_y > 1e-5


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

"""The fold kernel's host table (`CombineTable`, `CombineLayout`) and its
numpy walk against the reference's folds.

`combine_walk` reads the table as the kernel reads it — row groups,
staged union rows, quads of four rows, compact or wide entries, zero
padding, pieces of rows wider than a block can stage — and must give the
reference's int32 GEMM `_combine_shared` and host fold `_host_combine_i32`
bit for bit (tolerance 0: integer arithmetic modulo 2**32), on the serve
bank's real combine matrix, random sparse ones, one shared row,
coefficients to 2**30 (the sums wrap), a row with no nonzeros and a group
larger than the bank.  The table's own invariants are checked beside it.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compiler as rc
from repro.compiler.lowering import _host_combine_i32
from repro.filters import spread_lowpass_qbank
from repro.kernels.blmac_fir import _combine_shared
import repro_torch.compiler as tc
from repro_torch.filters import spread_lowpass_qbank as port_qbank

tk = importlib.import_module("repro_torch.kernels.blmac_fir")


def _sparse(n_real, n_shared, per_row, seed, top=14, empty=(0,)):
    """About ``per_row`` signed powers of two below 2**top a row, the
    rows in ``empty`` left without nonzeros."""
    rng = np.random.default_rng(seed)
    combine = np.zeros((n_real, n_shared), np.int64)
    rows = np.repeat(np.arange(n_real), per_row)
    cols = rng.integers(0, n_shared, rows.size)
    combine[rows, cols] = rng.choice([-1, 1], rows.size) << rng.integers(
        0, top, rows.size)
    combine[list(empty)] = 0
    return combine


def _serve_combine():
    port = tc.cse_pass(tc.compile_bank(port_qbank(256, 63))).combine
    ref = rc.cse_pass(rc.compile_bank(spread_lowpass_qbank(256, 63))).combine
    assert np.array_equal(port, ref)
    return port


CASES = {
    "serve": lambda: _serve_combine(),
    "random": lambda: _sparse(70, 40, 9, 1),
    "one_shared": lambda: _sparse(12, 1, 1, 2),
    "wrap": lambda: _sparse(30, 20, 8, 3, top=31),  # to 2**30: wide layout
    "empty_rows": lambda: _sparse(9, 6, 3, 4, empty=(0, 4, 8)),
    "small_bank": lambda: _sparse(3, 5, 2, 5, empty=()),
}


def _reference_folds(y, combine):
    n_real = combine.shape[0]
    host = _host_combine_i32(y, combine, n_real)
    xla = np.asarray(_combine_shared(jnp.asarray(y),
                                     jnp.asarray(combine.astype(np.int32)),
                                     n_real))
    assert np.array_equal(host, xla)
    return host


@pytest.mark.parametrize("n_groups", [1, 4, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_the_reference_folds(case, n_groups):
    combine = CASES[case]()
    n_real = combine.shape[0]
    rng = np.random.default_rng(n_groups)
    y = rng.integers(-(1 << 31), 1 << 31, (sum(combine.shape), 2, 37)) \
        .astype(np.int32)
    table = tk.combine_table(combine, "cpu")
    assert table.wide == (case == "wrap")
    layout = table.layout(n_groups)
    got = tk.combine_walk(y, layout, n_real)
    want = _reference_folds(y, combine)
    assert np.array_equal(got, want)
    plain = tk.combine_plain(torch.from_numpy(y), combine, n_real)
    assert np.array_equal(plain.numpy(), got)
    if case == "wrap":  # the exact sums leave int32
        exact = y[:n_real].astype(np.int64) + np.tensordot(
            combine, y[n_real:].astype(np.int64), axes=1)
        assert np.abs(exact).max() >= 1 << 31


def _entries(layout):
    """(row, shared row, coefficient) of every nonzero coefficient the
    table holds, decoded as the kernel decodes it."""
    out = []
    words = layout.table
    for g in range(layout.n_groups):
        union = layout.ulist[layout.group_union[g]:layout.group_union[g + 1]]
        for q in layout.quads[layout.group_quads[g]:
                              layout.group_quads[g + 1]]:
            quad = words[q[0]:q[0] + 4 * q[1]].reshape(q[1], 4, 4)
            for s in range(4):
                e = quad[:, s]
                if layout.wide:
                    place, c_a, c_b = e[:, 0], e[:, 1], e[:, 2]
                    assert not e[:, 3].any()
                else:
                    e = e.reshape(-1, 2)
                    place = e[:, 0] & 0xFFFF
                    c_a = e[:, 0].view(np.int32) >> 16
                    c_b = e[:, 1]
                c_a, c_b = c_a.view(np.int32), c_b.view(np.int32)
                # a place is 8 x a staged row, zero for a padding entry
                assert not (place % 8).any()
                assert not place[(c_a == 0) & (c_b == 0)].any()
                for row, coef in ((q[4 + s], c_a), (q[8 + s], c_b)):
                    if row < 0:
                        assert not coef.any()
                        continue
                    keep = coef != 0
                    out += [(int(row), int(union[i // 8]), int(c))
                            for i, c in zip(place[keep], coef[keep])]
    return out


@pytest.mark.parametrize("staged_max", [2, 5, tk.COMBINE_MAX_STAGED])
@pytest.mark.parametrize("n_groups", [1, 3, 1000])
def test_layout_holds_every_nonzero_once(n_groups, staged_max):
    combine = _sparse(90, 30, 6, 7, top=31, empty=(0, 50))
    combine[5] = 0
    combine[5, :12] = np.arange(1, 13)  # 12 nonzeros: pieces below 12
    table = tk.combine_table(combine, "cpu")
    layout = tk.CombineLayout(table.row_ptr, table.cols, table.coeffs, 30,
                              n_groups, table.wide, staged_max=staged_max)
    assert layout.max_union <= staged_max
    sizes = np.diff(layout.group_union)
    assert sizes.max() == layout.max_union
    for g in range(layout.n_groups):  # sorted, distinct, in range
        u = layout.ulist[layout.group_union[g]:layout.group_union[g + 1]]
        assert np.all(np.diff(u) > 0) and u.min() >= 0 and u.max() < 30
    held = {}
    pieces = set()
    for row, col, coef in _entries(layout):
        if row & tk.COMBINE_PIECE:
            pieces.add(row & (tk.COMBINE_PIECE - 1))
        r = row & (tk.COMBINE_PIECE - 1)
        assert (r, col) not in held
        held[(r, col)] = coef
    rows, cols = np.nonzero(combine)
    assert held == {(int(r), int(c)): int(np.int64(combine[r, c])
                                          .astype(np.int32))
                    for r, c in zip(rows, cols)}
    wide = {r for r in range(90) if np.count_nonzero(combine[r]) > staged_max}
    assert pieces == wide
    # a row is in one group unless it is cut into pieces
    where = {}
    for g in range(layout.n_groups):
        for q in layout.quads[layout.group_quads[g]:layout.group_quads[g + 1]]:
            assert not (q[8:] & tk.COMBINE_PIECE)[q[8:] >= 0].any()
            for row in q[4:]:
                if row >= 0 and not row & tk.COMBINE_PIECE:
                    assert row not in where
                    where[row] = g
    assert set(where) | wide == {r for r in range(90) if combine[r].any()}


def test_layout_balances_groups_and_quads():
    combine = CASES["serve"]()
    table = tk.combine_table(combine, "cpu")
    one = table.layout(1)
    assert one.n_groups == 1 and one.max_union == combine.shape[1]
    assert len(one.quads) == 256 // 2 // tk.COMBINE_QUAD  # all rows paired
    chunks = one.quads[:, 1]
    # longest first, every other round of warps reversed
    w = tk.COMBINE_WARPS
    assert np.all(np.diff(chunks[:w]) <= 0)
    assert np.all(np.diff(chunks[w:2 * w]) >= 0)
    # the pairs share shared rows: their entries, padding included, are
    # fewer than the nonzeros (two a 16-byte chunk)
    assert one.table.shape[0] * 2 < 0.75 * table.nnz
    single = tk.CombineLayout(table.row_ptr, table.cols, table.coeffs,
                              table.n_shared, 1, table.wide, pair=False)
    assert len(single.quads) == 256 // tk.COMBINE_QUAD
    assert single.table.shape[0] * 2 > table.nnz
    eight = table.layout(8)
    nnz = [sum(np.count_nonzero(combine[r]) for q in eight.quads[
        eight.group_quads[g]:eight.group_quads[g + 1]] for r in q[4:]
        if r >= 0) for g in range(8)]
    assert max(nnz) < 1.1 * table.nnz / 8
    assert eight.max_union < combine.shape[1]  # neighbours share columns
    assert table.layout(8) is eight  # cached


@pytest.mark.parametrize("block", [None, 64])
def test_pair_rows_pairs_each_row_once_by_shared_columns(block, monkeypatch):
    if block:  # pairs found block by block
        monkeypatch.setattr(tk, "COMBINE_PAIR_BLOCK", block)
    combine = CASES["serve"]()
    table = tk.combine_table(combine, "cpu")
    rows = np.arange(256)
    pairs = tk.pair_rows(rows, table.row_ptr, table.cols, table.n_shared)
    assert pairs.shape == (128, 2)
    assert np.array_equal(np.sort(pairs.ravel()), rows)
    nz = combine != 0
    shared = sum(int((nz[a] & nz[b]).sum()) for a, b in pairs)
    adjacent = sum(int((nz[r] & nz[r + 1]).sum()) for r in range(0, 256, 2))
    assert shared > 1.3 * adjacent
    odd = tk.pair_rows(rows[:7], table.row_ptr, table.cols, table.n_shared)
    assert odd.shape == (4, 2) and (odd[:, 1] == -1).sum() == 1
    assert set(odd.ravel()) - {-1} == set(range(7))


def test_groups_for_fills_the_grid():
    table = tk.combine_table(_sparse(1000, 50, 4, 8, empty=()), "cpu")
    sms = 132
    assert table.groups_for(1, 4096, sms) == 1  # 128 spans
    assert table.groups_for(1, 16258, sms) == 1
    assert table.groups_for(1, 1000, sms) == 4  # 32 spans
    assert table.groups_for(3, 1000, sms) == 1
    assert table.groups_for(1, 20, sms) == 8  # a quad a warp: 1000 rows
    small = tk.combine_table(_sparse(10, 5, 2, 9), "cpu")
    assert small.groups_for(1, 20, sms) == 1


@pytest.mark.parametrize("extra, wide", [(None, False), (1 << 15, True),
                                         (-(1 << 15) - 1, True),
                                         (-(1 << 31), True)])
def test_compact_and_wide_entries(extra, wide):
    combine = np.zeros((2, 3), np.int64)
    combine[0, 1] = -(1 << 15)  # the compact entry's range, both ends
    combine[1, 2] = (1 << 15) - 1
    if extra is not None:
        combine[1, 0] = extra
    table = tk.CombineTable(combine)
    assert table.wide == wide
    y = np.random.default_rng(10).integers(-(1 << 31), 1 << 31, (5, 1, 9)) \
        .astype(np.int32)
    assert np.array_equal(tk.combine_walk(y, table.layout(1), 2),
                          _reference_folds(y, combine))


def test_all_zero_matrix_keeps_one_empty_group():
    combine = np.zeros((4, 6), np.int64)
    table = tk.combine_table(combine, "cpu")
    layout = table.layout(4)
    assert layout.n_groups == 1 and layout.max_union == 0
    assert len(layout.quads) == 0
    y = np.arange(10 * 2 * 3, dtype=np.int32).reshape(10, 2, 3)
    assert np.array_equal(tk.combine_walk(y, layout, 4), y[:4])

"""Cross-filter common-subexpression elimination over a compiled bank.

The port's numpy copy of `repro.compiler.optimize`.  `cse_pass(program)`
rewrites a compiled bank so that the most frequent signed CSD digit-pair
patterns — 2-term subexpressions ``(j, delta, ss)``: two pulses on folded
tap ``j``, ``delta`` layers apart, sign product ``ss`` — are computed
once, as shared rows, and reused wherever they occur:

  * each chosen pattern becomes one *virtual row* appended to the bank
    (value ``1 + ss·2^delta`` at tap ``j``, a valid NAF string since NAF
    forbids adjacent pulses, so ``delta >= 2``);
  * every occurrence at base layer ``l`` with leading sign ``sigma`` is
    deleted from its real row (−2 pulses) and recorded as the coefficient
    ``sigma·2^l`` of an ``(n_real, n_shared)`` *combine* matrix (+1 add);
  * deleting digits of a NAF string leaves the NAF of the new value, so
    the reduced rows pack, schedule and run through every kernel as any
    bank does; the consumer then folds the shared rows back in
    (``y[r] += Σ_s combine[r, s] · y[n_real + s]``, int32 modulo 2^32 —
    the combine kernel of `repro_torch.kernels.blmac_fir`).

Exactness does not need the augmented rows inside the §2.1 bound: int32
adds, shifts and products are ring arithmetic modulo 2^32, the fold is
linear, and the combined value is the parent's output, which the
parent's bound keeps inside int32.

Greedy: the highest-count pattern is committed (every non-overlapping
occurrence at once, LSB first) when it saves at least one add, and only
the changed tap row is re-counted; removals never create pairs, so the
pass ends.  The mining, the assembly and the content key are the
reference's, step for step, so both packages give the same optimized
program for the same parent — the same key and arrays — and a file
either saves loads in the other.

Optimized programs are memoized per ``(parent.key, "cse", level,
max_shared)`` (`STATS["cse"]` in `cache_stats()`, `CSE_MEMO_MAX`
entries).  ``level="ilp"`` (the adder-minimal integer program of
Kumm/Volkova/Filip, arXiv:1912.04210) raises `NotImplementedError`, as in
the reference.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from ..core.csd import (layer_occupancy, occupancy_signatures, pack_trits,
                        packed_pulse_counts, unpack_trits)
from ..core.io import atomic_write
from ..core.machine import MachineSpec
from .cache import PROGRAM_CACHE, STATS, _bump
from .program import (PROGRAM_FORMAT_VERSION, BlmacProgram, CompileSpec,
                      ProgramFormatError, _packed_key, _qbank_key,
                      compile_bank)

__all__ = ["OptimizedProgram", "cse_pass", "CSE_MEMO_MAX"]

# the memo holds whole optimized programs (augmented packed banks), so it
# is bounded; an evicted entry just re-mines
CSE_MEMO_MAX = 16
_CSE_MEMO: dict = {}

def _memo_key(parent_key: str, level, max_shared):
    return (parent_key, "cse", level, max_shared)


def _spec_dict(spec: CompileSpec) -> dict:
    return {"coeff_bits": spec.coeff_bits, "sample_bits": spec.sample_bits,
            "n_layers": spec.n_layers}


class OptimizedProgram(BlmacProgram):
    """A CSE-optimized bank: the parent's filters over a shared-row layout.

    The base-class arrays describe the augmented bank — ``n_real`` reduced
    real rows, then ``n_shared`` virtual 2-pulse rows — so every consumer
    of a `BlmacProgram` (schedules, kernel tables, the cost model) runs it
    unchanged; the consumer then folds the shared rows into the real ones
    with ``combine``.

    Extra attributes
    ----------------
    parent : BlmacProgram
        The unoptimized program; ``effective_qbank() == parent.qbank``.
    n_real, n_shared : int
        Real-filter and virtual-row counts (``n_filters`` is their sum).
    combine : (n_real, n_shared) int64
        Signed power-of-two reuse coefficients; column ``p`` folds shared
        row ``p`` into each real output.
    use_counts : (n_real,) int64
        Combine adds per real filter — the +1-cycle term of the §4 cycle
        model and the +1-add term of the §3.3 adds count.
    """

    def __init__(self, *, parent, combine, use_counts, level, **kw):
        super().__init__(**kw)
        self.parent = parent
        self.combine = combine
        self.use_counts = use_counts
        self.level = level
        self.n_real = int(combine.shape[0])
        self.n_shared = int(combine.shape[1])
        self.parent_key = parent.key
        for a in (combine, use_counts):
            a.setflags(write=False)
        self._bank = None

    def __repr__(self) -> str:
        return (
            f"OptimizedProgram(B={self.n_real}+{self.n_shared} shared, "
            f"taps={self.taps}, layers={self.n_layers}, "
            f"key={self.key[:12]}…)"
        )

    # -- semantics -----------------------------------------------------------

    @property
    def out_filters(self) -> int:
        """Filters this program serves (the parent's count) — fewer than
        ``n_filters``, which also counts the virtual rows."""
        return self.n_real

    def effective_qbank(self) -> np.ndarray:
        """The (n_real, taps) coefficients the program implements after
        the fold — equal to ``parent.qbank`` by construction."""
        shared = self.qbank[self.n_real:]
        return self.qbank[: self.n_real] + self.combine @ shared

    @property
    def bank(self) -> BlmacProgram:
        """The augmented rows as a plain program (for consumers that
        partition rows; the caller folds ``combine`` afterwards), built
        from this program's arrays: the augmented rows may exceed the
        parent's §2.1 bound, which the fold makes harmless, so the
        bound's re-assert is bypassed."""
        if self._bank is None:
            pkey = _packed_key(self.packed, self.taps,
                               self.spec.sample_bits)
            plain = PROGRAM_CACHE.get(pkey)
            if plain is None:
                plain = BlmacProgram(
                    qbank=self.qbank, exponents=self.exponents,
                    packed=self.packed, occupancy=self.occupancy,
                    signatures=self.signatures,
                    pulse_counts=self.pulse_counts,
                    spec=self.spec, key=pkey[1].hex(),
                )
                if self._half_digits is not None:
                    plain._half_digits = self._half_digits
                PROGRAM_CACHE.put(
                    plain, pkey, _qbank_key(self.qbank, self.spec)
                )
            self._bank = plain
        return self._bank

    def total_adds(self) -> int:
        """§3.3 additions for one output sample of every real filter: the
        folds, every remaining pulse (the virtual rows' two each, once per
        bank), plus one combine add per use."""
        return (
            self.n_real * (self.taps // 2)
            + int(self.pulse_counts.sum())
            + int(self.use_counts.sum())
        )

    def machine_cycles(self, spec=None) -> np.ndarray:
        """(n_real,) §4 cycles per output for each real filter: the
        reduced row's own RLE codes plus one cycle per combine add.
        Shared-row cycles are bank-level (each virtual row runs once for
        all its consumers) — see `shared_cycles`.

        The default spec is widened to ``n_layers + 1`` coefficient
        bits: reduced and virtual rows can exceed the parent's
        magnitude range even though their outputs recombine into it.
        """
        if spec is None:
            spec = MachineSpec(taps=self.taps,
                               coeff_bits=self.n_layers + 1)
        base = super().machine_cycles(spec)
        cycles = base[: self.n_real] + self.use_counts
        cycles.setflags(write=False)
        return cycles

    def shared_cycles(self, spec=None) -> np.ndarray:
        """(n_shared,) §4 cycles of the virtual rows — amortized once
        per bank per output sample."""
        if spec is None:
            spec = MachineSpec(taps=self.taps,
                               coeff_bits=self.n_layers + 1)
        return super().machine_cycles(spec)[self.n_real:]

    # -- cost-model reads ----------------------------------------------------

    @property
    def nnz(self) -> int:
        """Nonzeros of the combine matrix: the fold's multiply-adds per
        output sample."""
        return int(np.count_nonzero(self.combine))

    def fold_entries(self, channels, n_out, cal=None) -> int | None:
        """The fold kernel's table entries for a launch over ``channels``
        × ``n_out`` on a card of ``cal.sms`` SMs — the ``"cuda"`` lane's
        work a sample — from the host's layout of the combine matrix
        (built once, cached with its table); None on another lane."""
        from ..core.costmodel import CUDA_LANE

        if cal is None or cal.lane != CUDA_LANE:
            return None
        from ..kernels.blmac_fir import combine_table

        table = combine_table(self.combine, "cpu")
        return table.layout(table.groups_for(channels, n_out,
                                             cal.sms)).entries

    def predict_scheduled_us(self, channels, n_tiles, tile,
                             bank_tile=None, merge=None, cal=None) -> float:
        """Augmented-schedule latency plus the fold's price — what the
        planner compares with the parent's own plan to decline the pass."""
        from ..core.costmodel import predict_combine_us

        base = super().predict_scheduled_us(
            channels, n_tiles, tile, bank_tile, merge, cal=cal
        )
        return base + predict_combine_us(
            self.n_real, self.n_shared, channels, n_tiles, tile, cal=cal,
            nnz=self.nnz,
            entries=self.fold_entries(channels, n_tiles * tile, cal),
        )

    def predict_specialized_us(self, channels, n_tiles, cal=None,
                               tile: int = 1) -> float:
        """Augmented-bank latency of the specialized path plus the fold:
        priced, as the reference does, over one unit tile per signal tile
        on the reference lane, and over every output (``tile`` each) on
        the ``"cuda"`` lane."""
        from ..core.costmodel import CUDA_LANE, predict_combine_us

        base = super().predict_specialized_us(channels, n_tiles, cal=cal,
                                              tile=tile)
        fold_tile = tile if cal is not None and cal.lane == CUDA_LANE else 1
        return base + predict_combine_us(
            self.n_real, self.n_shared, channels, n_tiles, fold_tile,
            cal=cal, nnz=self.nnz,
            entries=self.fold_entries(channels, n_tiles * fold_tile, cal),
        )

    # -- row-structure hooks that do not survive the combine -----------------

    def select(self, rows):
        raise NotImplementedError(
            "OptimizedProgram rows are coupled through the combine "
            "matrix; select() from the parent program, or shard the "
            "augmented rows via .bank and apply .combine afterwards"
        )

    def partition(self, n_shards):
        raise NotImplementedError(
            "partition the augmented rows via .bank and apply .combine "
            "after reassembly"
        )

    # -- serialization -------------------------------------------------------

    def save(self, path) -> None:
        """`BlmacProgram.save` plus the sharing structure: the combine and
        use-count arrays and a ``cse`` header section — the reference's
        layout, so either package loads the file and rebuilds (and
        key-checks) the parent by linearity."""
        header = {
            "format_version": PROGRAM_FORMAT_VERSION,
            "kind": "blmac_program",
            "key": self.key,
            "packed_digest": _packed_key(
                self.packed, self.taps, self.spec.sample_bits
            )[1].hex(),
            "n_filters": self.n_filters,
            "taps": self.taps,
            "n_layers": self.n_layers,
            "n_words": self.n_words,
            "spec": _spec_dict(self.spec),
            "cse": {
                "level": self.level,
                "n_real": self.n_real,
                "parent_key": self.parent_key,
                "parent_spec": _spec_dict(self.parent.spec),
            },
        }
        atomic_write(path, lambda f: np.savez(
            f,
            header=np.array(json.dumps(header)),
            qbank=self.qbank,
            exponents=self.exponents,
            packed=self.packed,
            combine=self.combine,
            use_counts=self.use_counts,
        ))


def _cse_content_key(parent_key: str, level, combine: np.ndarray,
                     packed: np.ndarray) -> str:
    """The optimized program's content address, the reference's byte for
    byte: the ``(parent.key, pass, level)`` triple plus digests of the
    pass's output (so a corrupted file cannot take the honest key)."""
    h = hashlib.sha256()
    h.update(repr((parent_key, "cse", level)).encode())
    h.update(np.ascontiguousarray(combine))
    h.update(np.ascontiguousarray(packed))
    return h.hexdigest()


def _greedy2(digits: np.ndarray, max_shared: int | None):
    """The greedy weight-level 2-term miner.

    ``digits`` is a writable (B, M, L) int8 copy of the parent's folded
    CSD digits; returns ``(reduced_digits, virtual_digits, combine,
    use_counts, patterns)`` where ``patterns`` maps ``(j, delta, ss)`` to
    its virtual-row index.
    """
    n_real, m_taps, n_layers = digits.shape
    deltas = range(2, n_layers)  # NAF: no adjacent pulses

    def pair_counts(rows: np.ndarray) -> np.ndarray:
        """(B, M', L) digits → (M', L, 2) pattern counts; index 0 of the
        last axis counts sign product +1, index 1 counts −1."""
        c = np.zeros((rows.shape[1], n_layers, 2), np.int64)
        r16 = rows.astype(np.int16)
        for delta in deltas:
            prod = r16[:, :, :-delta] * r16[:, :, delta:]
            c[:, delta, 0] = (prod == 1).sum(axis=(0, 2))
            c[:, delta, 1] = (prod == -1).sum(axis=(0, 2))
        return c

    counts = pair_counts(digits)  # (M, L, 2)
    patterns: dict = {}
    columns: list = []
    use_counts = np.zeros(n_real, np.int64)
    dead = np.zeros(counts.shape, bool)  # candidates that failed commit

    while True:
        score = counts - 2  # new pattern: +2 pulses for the virtual row
        score[dead] = 0
        if max_shared is not None and len(patterns) >= max_shared:
            break
        flat = int(np.argmax(score))
        if score.flat[flat] < 1:
            break
        j, delta, s = np.unravel_index(flat, score.shape)
        j, delta, ss = int(j), int(delta), 1 if s == 0 else -1

        # every non-overlapping occurrence, greedily LSB first: scan base
        # layers ascending, vectorized over filters, skipping pairs that
        # share a pulse with a pair already taken (NAF chains)
        row = digits[:, j, :]
        prod = row[:, :-delta].astype(np.int16) * row[:, delta:]
        mask = prod == ss
        used = np.zeros((n_real, n_layers), bool)
        occ_b, occ_l = [], []
        for low in range(n_layers - delta):
            take = mask[:, low] & ~used[:, low] & ~used[:, low + delta]
            if take.any():
                bs = np.nonzero(take)[0]
                occ_b.append(bs)
                occ_l.append(np.full(bs.size, low, np.int64))
                used[bs, low] = True
                used[bs, low + delta] = True
        n_occ = sum(len(b) for b in occ_b)
        if n_occ - 2 < 1:  # overlap made the estimate unprofitable
            dead[j, delta, s] = True
            continue

        col = np.zeros(n_real, np.int64)
        bs = np.concatenate(occ_b)
        ls = np.concatenate(occ_l)
        sigma = digits[bs, j, ls].astype(np.int64)
        digits[bs, j, ls] = 0
        digits[bs, j, ls + delta] = 0
        np.add.at(col, bs, sigma << ls)
        np.add.at(use_counts, bs, 1)
        patterns[(j, delta, ss)] = len(columns)
        columns.append(col)
        counts[j] = pair_counts(digits[:, j : j + 1, :])[0]
        dead[j] = False  # the row changed: retry its failed candidates

    n_shared = len(columns)
    virtual = np.zeros((n_shared, m_taps, n_layers), np.int8)
    for (j, delta, ss), p in patterns.items():
        virtual[p, j, 0] = 1
        virtual[p, j, delta] = ss
    combine = (
        np.stack(columns, axis=1)
        if columns else np.zeros((n_real, 0), np.int64)
    )
    return digits, virtual, combine, use_counts, patterns


def cse_pass(program: BlmacProgram, level=2, *,
             max_shared: int | None = None) -> BlmacProgram:
    """Optimize a compiled bank by sharing 2-term partial sums across
    filters.  Returns an `OptimizedProgram`, or ``program`` itself when
    no sharing pays (the pass declines) or ``program`` is already
    optimized.

    ``level`` is ``2`` (the greedy 2-term pass) or ``"ilp"`` (raises
    `NotImplementedError`: the adder-minimal integer program of
    Kumm/Volkova/Filip is not implemented); ``max_shared`` caps the
    virtual rows (None: no cap).  Memoized per ``(parent.key, level,
    max_shared)``: `STATS["cse"]` counts the memo's hits and misses,
    ``counters["cse_passes"]`` the mines.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.compiler import compile_bank, cse_pass
    >>> bank = np.zeros((3, 15), np.int64)
    >>> bank[:, 7] = [9, 9, 9]                   # 9 = 2^0 + 2^3, shared
    >>> opt = cse_pass(compile_bank(bank))
    >>> int(opt.n_shared), int(opt.pulse_counts.sum())
    (1, 2)
    >>> np.array_equal(opt.effective_qbank(), compile_bank(bank).qbank)
    True
    """
    if level == "ilp":
        raise NotImplementedError(
            "level='ilp' is the adder-minimal integer linear program of "
            "Kumm/Volkova/Filip, 'Design of Optimal Multiplierless FIR "
            "Filters' (arXiv:1912.04210); only the greedy level=2 pass is "
            "implemented"
        )
    if level != 2:
        raise ValueError(f"unsupported CSE level {level!r} (use 2 or 'ilp')")
    if not isinstance(program, BlmacProgram):
        raise TypeError(f"cse_pass needs a BlmacProgram, got {program!r}")
    if isinstance(program, OptimizedProgram):
        return program

    mkey = _memo_key(program.key, level, max_shared)
    cached = _CSE_MEMO.get(mkey)
    if cached is not None:
        STATS["cse"].hit()
        return cached
    STATS["cse"].miss()
    _bump("cse_passes")

    digits = np.array(program.half_digits(), np.int8)  # writable copy
    reduced, virtual, combine, use_counts, _ = _greedy2(digits, max_shared)
    if combine.shape[1] == 0:
        _memo_register(mkey, program)
        return program

    opt = _assemble(program, reduced, virtual, combine, use_counts, level)
    _memo_register(mkey, opt)
    return opt


def _memo_register(mkey, prog) -> None:
    _CSE_MEMO[mkey] = prog
    while len(_CSE_MEMO) > CSE_MEMO_MAX:
        del _CSE_MEMO[next(iter(_CSE_MEMO))]


def _assemble(parent: BlmacProgram, reduced: np.ndarray,
              virtual: np.ndarray, combine: np.ndarray,
              use_counts: np.ndarray, level) -> OptimizedProgram:
    """Augmented arrays → `OptimizedProgram`, bypassing the §2.1
    re-assert (module docstring) but deriving every view as
    `compile_bank` does."""
    aug = np.concatenate([reduced, virtual], axis=0)  # (B+P, M, L)
    packed = pack_trits(np.swapaxes(aug, 1, 2))
    weights = np.int64(1) << np.arange(aug.shape[-1], dtype=np.int64)
    halves = (aug.astype(np.int64) * weights).sum(axis=-1)
    qbank = np.ascontiguousarray(
        np.concatenate([halves, halves[:, :-1][:, ::-1]], axis=1)
    )
    occupancy = np.ascontiguousarray(layer_occupancy(aug))
    exponents = np.concatenate([
        parent.exponents,
        np.zeros(virtual.shape[0], np.int64),
    ])
    spec = CompileSpec(
        coeff_bits=parent.spec.coeff_bits,
        sample_bits=parent.spec.sample_bits,
        n_layers=parent.n_layers,
    )
    combine = np.ascontiguousarray(combine, np.int64)
    opt = OptimizedProgram(
        parent=parent,
        combine=combine,
        use_counts=np.ascontiguousarray(use_counts, np.int64),
        level=level,
        qbank=qbank,
        exponents=np.ascontiguousarray(exponents),
        packed=packed,
        occupancy=occupancy,
        signatures=np.ascontiguousarray(occupancy_signatures(occupancy)),
        pulse_counts=packed_pulse_counts(packed),
        spec=spec,
        key=_cse_content_key(parent.key, level, combine, packed),
    )
    aug = np.ascontiguousarray(aug)
    aug.setflags(write=False)
    opt._half_digits = aug
    return opt


def _rebuild_optimized(qbank, exponents, packed, combine, use_counts,
                       level, parent_spec: CompileSpec, *,
                       parent_key: str | None = None,
                       key: str | None = None) -> OptimizedProgram:
    """Stored augmented arrays (whose coefficients the caller has checked
    against the trits) → the `OptimizedProgram`: the parent rebuilt by
    linearity, held to ``parent_key`` and the result to ``key`` when they
    are given (a file's header); raises ``ValueError`` otherwise.  A memo
    hit returns the program already mined."""
    n_real = combine.shape[0]
    combine = np.ascontiguousarray(combine, np.int64)
    use_counts = np.ascontiguousarray(use_counts, np.int64)
    n_shared = qbank.shape[0] - n_real
    if combine.shape != (n_real, n_shared) or use_counts.shape != (n_real,):
        raise ValueError("combine/use_counts shapes do not match the bank")
    if parent_key is not None and key is not None and _cse_content_key(
            parent_key, level, combine, packed) != key:
        raise ValueError("optimized-program content key mismatch "
                         "(corrupted file?)")
    parent_q = qbank[:n_real] + combine @ qbank[n_real:]
    parent = compile_bank(parent_q, parent_spec)
    if parent_key is not None and parent.key != parent_key:
        raise ValueError("the rebuilt parent does not match the stored "
                         "parent key (corrupted file?)")
    opt_key = _cse_content_key(parent.key, level, combine, packed)
    mkey = _memo_key(parent.key, level, None)
    cached = _CSE_MEMO.get(mkey)
    if isinstance(cached, OptimizedProgram) and cached.key == opt_key:
        STATS["cse"].hit()
        return cached
    half = qbank.shape[1] // 2
    digits = np.ascontiguousarray(
        np.swapaxes(unpack_trits(packed, half + 1), 1, 2)
    )
    opt = _assemble(parent, digits[:n_real], digits[n_real:],
                    combine, use_counts, level)
    _memo_register(mkey, opt)
    return opt


def _load_optimized(path, header, qbank, exponents, packed,
                    combine, use_counts) -> OptimizedProgram:
    """`BlmacProgram.load`'s branch for files with a ``cse`` header
    section (digest and trit-decode checks already done by the caller):
    the parent rebuilt by linearity and held to its stored key, so a
    corrupted combine matrix cannot serve the wrong filters."""
    cse = header["cse"]
    if combine is None or use_counts is None:
        raise ProgramFormatError(
            f"{path}: optimized program is missing combine/use_counts"
        )
    if combine.shape[:1] != (int(cse["n_real"]),):
        raise ProgramFormatError(
            f"{path}: combine/use_counts shapes do not match the header"
        )
    try:
        return _rebuild_optimized(
            qbank, exponents, packed, combine, use_counts, cse["level"],
            CompileSpec(**cse["parent_spec"]),
            parent_key=cse["parent_key"], key=header.get("key"),
        )
    except ValueError as e:
        raise ProgramFormatError(f"{path}: {e}") from e

"""`compile_bank(coeffs, spec) -> BlmacProgram`: filter compilation as a
cached, serializable step — the port's copy of `repro.compiler.program`.

A compiled filter bank is quantized taps → CSD bit layers → packed 2-bit
trit words (the bank kernel's operand) plus the views every backend
reads: per-filter layer occupancy, occupancy signatures, pulse counts,
memoized superlayer schedules per ``(bank_tile, merge)`` and per-filter
MSB-first pulse tuples, and memoized §4 machine cycle counts per
`MachineSpec` (`machine_cycles`).

The content address (`BlmacProgram.key`) and the on-disk format
(`PROGRAM_FORMAT_VERSION`, npz + JSON header) are the reference's, byte
for byte, so one saved program file serves both packages and a program
built here from the reference's arrays (`program_from_arrays`) carries
the reference's key.  The same holds for a CSE-optimized program
(`repro_torch.compiler.optimize.OptimizedProgram`): a file either
package's CSE pass saved loads in the other under the same key.  The
dispatch planner reads its inputs off the program (`mean_pulses`,
`predict_specialized_us`, `predict_scheduled_us`).  The sharded engine
and its planner read memoized bank partitions (`partition`) and shard
subprograms (`select`), each registered under the reference's key for
the same rows.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np

from ..core.csd import (assert_int32_bound, csd_decode, csd_digits,
                        layer_occupancy, occupancy_signatures, pack_trits,
                        packed_pulse_counts, require_type1, unpack_trits)
from ..core.io import atomic_write, check_format_header
from ..core.machine import MachineSpec
from ..core.rle import code_count_batch
from ..tracing import span
from .cache import PROGRAM_CACHE, _bump
from .schedule import (BankSchedule, MERGE_DEFAULT, default_bank_tile,
                       plan_bank_schedule)

__all__ = [
    "CompileSpec",
    "BlmacProgram",
    "ProgramFormatError",
    "PROGRAM_FORMAT_VERSION",
    "compile_bank",
    "compile_packed",
    "pack_bank_trits",
    "program_from_arrays",
]

# the reference's on-disk layout version; `load` rejects other versions
# instead of mis-parsing them
PROGRAM_FORMAT_VERSION = 1
TRITS_PER_WORD = 16


class ProgramFormatError(ValueError):
    """A saved program file has the wrong version or is corrupted."""


@dataclass(frozen=True)
class CompileSpec:
    """Compilation parameters — part of the program's content address.

    ``coeff_bits`` is the §3.2 quantization width applied to FLOAT
    coefficient input (integer banks are taken as already quantized);
    ``sample_bits`` the input-sample width of the §2.1 int32 accumulator
    bound, asserted once at compile; ``n_layers`` overrides the CSD digit
    count (None = minimal for the bank's magnitude range).
    """

    coeff_bits: int = 16
    sample_bits: int = 8
    n_layers: int | None = None


def _bank_digits(qbank: np.ndarray, n_layers: int | None) -> np.ndarray:
    """(B, taps) symmetric ints → (B, M, L) CSD digits of the folded half,
    counted in `cache_stats()["counters"]["csd_packings"]`."""
    _bump("csd_packings")
    half = qbank.shape[-1] // 2
    return csd_digits(qbank[:, : half + 1], n_digits=n_layers)


def pack_bank_trits(
    qbank: np.ndarray,
    n_layers: int | None = None,
    sample_bits: int = 8,
) -> np.ndarray:
    """(B, taps) symmetric int coefficients → (B, n_layers, n_words) uint32
    packed trit words over the folded half-filter (M = taps//2 + 1 rows),
    layer-major: the bank kernel's raw operand, word for word the
    reference's.

    Asserts type I and the §2.1 int32 accumulator bound for
    ``sample_bits`` inputs here, once per pack; `blmac_fir_bank` and
    `compile_packed` take the result as it is.  Prefer `compile_bank`
    beyond a one-off pack: it caches the result content-addressed.
    """
    qbank = np.asarray(qbank, np.int64)
    if qbank.ndim != 2:
        raise ValueError("qbank must be (n_filters, taps)")
    require_type1(qbank, "bank kernel")
    assert_int32_bound(qbank, sample_bits, "bank kernel")
    digits = _bank_digits(qbank, n_layers)  # (B, M, L)
    return pack_trits(np.swapaxes(digits, 1, 2))  # (B, L, n_words)


def _qbank_key(qbank: np.ndarray, spec: CompileSpec):
    return (
        "q", hashlib.sha256(np.ascontiguousarray(qbank)).digest(),
        qbank.shape, spec.sample_bits, spec.n_layers,
    )


def _packed_key(packed: np.ndarray, taps: int, sample_bits: int):
    # geometry is folded into the digest itself: the digest doubles as
    # `BlmacProgram.key`, and identical trit bytes can arise from
    # different tap counts (zero-padded trailing slots of the last word)
    h = hashlib.sha256(np.ascontiguousarray(packed))
    h.update(repr((packed.shape, int(taps), int(sample_bits))).encode())
    return ("p", h.digest(), packed.shape, int(taps), int(sample_bits))


def _memo_put(memo: dict, key, value, cap: int) -> None:
    """Insert into a bounded FIFO memo (dicts keep insertion order)."""
    memo[key] = value
    while len(memo) > cap:
        del memo[next(iter(memo))]


SCHEDULE_MEMO_MAX = 16
SUBPROGRAM_MEMO_MAX = 32


class BlmacProgram:
    """One compiled BLMAC filter bank — the artifact every backend executes.

    Read-only by contract (the arrays are flagged unwritable).  Construct
    via `compile_bank` / `compile_packed` / `program_from_arrays` /
    `load`, never directly.

    Attributes
    ----------
    key : str
        Hex content digest of the packed trit operand (the reference's
        digest, stable across ``save``/``load`` and across packages).
    qbank : (B, taps) int64
        Quantized coefficients.
    exponents : (B,) int64
        Per-filter §3.2 power-of-two scale exponents (zero when compiled
        from already-quantized integers).
    packed : (B, n_layers, n_words) uint32
        Packed 2-bit trit words over the folded half-filter.
    occupancy : (B, n_layers) bool;  signatures : (B,) uint64
        Which bit layers hold pulses, and the sort key of the schedule.
    pulse_counts : (B,) int64
        Non-zero trits per filter.
    """

    # non-None only on an `OptimizedProgram` (compiler/optimize.py): plain
    # consumers branch on `program.combine is not None`
    combine = None
    parent = None

    def __init__(self, *, qbank, exponents, packed, occupancy, signatures,
                 pulse_counts, spec: CompileSpec, key: str):
        self.qbank = qbank
        self.exponents = exponents
        self.packed = packed
        self.occupancy = occupancy
        self.signatures = signatures
        self.pulse_counts = pulse_counts
        self.spec = spec
        self.key = key
        self.n_filters, self.taps = qbank.shape
        _, self.n_layers, self.n_words = packed.shape
        for a in (qbank, exponents, packed, occupancy, signatures,
                  pulse_counts):
            a.setflags(write=False)
        self._schedules: dict = {}
        self._cycle_cache: dict = {}
        self._half_digits = None
        self._pulse_schedules = None
        self._partitions: dict = {}
        self._subprograms: dict = {}

    def __repr__(self) -> str:
        return (
            f"BlmacProgram(B={self.n_filters}, taps={self.taps}, "
            f"layers={self.n_layers}, key={self.key[:12]}…)"
        )

    # -- derived views -------------------------------------------------------

    @property
    def mean_pulses(self) -> float:
        """Bank-average BLMAC pulses per filter (the cost model's knob)."""
        return float(self.pulse_counts.mean()) if self.n_filters else 0.0

    @property
    def out_filters(self) -> int:
        """Filters this program serves: ``n_filters`` here; an
        `OptimizedProgram` serves fewer than its rows (the rest are shared
        partial sums)."""
        return self.n_filters

    def total_adds(self) -> int:
        """§3.3 additions for one output sample of the whole bank:
        ``taps // 2`` symmetric folds per filter plus one add per CSD
        pulse — the baseline the CSE pass reduces."""
        return self.n_filters * (self.taps // 2) + int(
            self.pulse_counts.sum()
        )

    def half_digits(self) -> np.ndarray:
        """(B, M, n_layers) int8 signed CSD digits of the folded half,
        LSB-first layers — unpacked from the trit words once, then shared
        (read-only)."""
        if self._half_digits is None:
            half = self.taps // 2
            d = unpack_trits(self.packed, half + 1)  # (B, L, M)
            d = np.ascontiguousarray(np.swapaxes(d, 1, 2))
            d.setflags(write=False)
            self._half_digits = d
        return self._half_digits

    def pulse_schedules(self) -> tuple:
        """Per-filter MSB-first static pulse tuples ``(layer, j, sign)`` —
        the `specialized_program` input, derived once from the digits."""
        if self._pulse_schedules is None:
            digits = self.half_digits()  # (B, M, L)
            out = []
            for b in range(self.n_filters):
                d = digits[b]
                pulses = []
                for layer in range(d.shape[1] - 1, -1, -1):
                    for j in np.nonzero(d[:, layer])[0]:
                        pulses.append((int(layer), int(j), int(d[j, layer])))
                out.append(tuple(pulses))
            self._pulse_schedules = tuple(out)
        return self._pulse_schedules

    def schedule(
        self, bank_tile: int | None = None, merge: int | None = None
    ) -> BankSchedule:
        """The memoized superlayer schedule for one kernel geometry: one
        `plan_bank_schedule` per distinct ``(bank_tile, merge)``."""
        bt = default_bank_tile(self.n_filters) if bank_tile is None \
            else int(bank_tile)
        mg = MERGE_DEFAULT if merge is None else int(merge)
        key = (bt, mg)
        if key not in self._schedules:
            _memo_put(
                self._schedules, key,
                plan_bank_schedule(self.packed, bt, mg), SCHEDULE_MEMO_MAX,
            )
        return self._schedules[key]

    def partition(self, n_shards: int):
        """Memoized occupancy-balanced `BankPartition` over ``n_shards``
        contiguous (post-occupancy-sort) filter shards — the sharded
        engine's and the mesh planner's shared plan.

        Raises ``ValueError`` for an empty bank; ``n_shards`` is clamped
        to ``1 .. n_filters``.

        Examples
        --------
        >>> import numpy as np
        >>> from repro_torch.compiler import compile_bank
        >>> bank = np.zeros((4, 15), np.int64)
        >>> bank[:, 7] = [64, 96, 160, 224]
        >>> part = compile_bank(bank).partition(2)
        >>> sorted(len(rows) for rows in part.assign)
        [2, 2]
        """
        from ..distributed.sharding import partition_bank

        n_shards = int(n_shards)
        if n_shards not in self._partitions:
            self._partitions[n_shards] = partition_bank(
                self.packed, n_shards, self.taps,
                cost=self.filter_costs, sig=self.signatures,
            )
        return self._partitions[n_shards]

    @property
    def filter_costs(self) -> np.ndarray:
        """(B,) per-filter work the partition balances: pulses plus the
        ``taps // 2`` symmetric folds (§3.3)."""
        return self.pulse_counts.astype(np.float64) + self.taps // 2

    def select(self, rows) -> "BlmacProgram":
        """The subprogram serving ``rows`` (original filter indices, in
        order): array slices of this program, no recompilation.  Memoized
        here and registered content-addressed under the reference's key
        for the same rows, so the planner and the engine asking for one
        shard get one object, and its key equals `repro`'s.

        Raises ``IndexError`` for a row out of range.

        Examples
        --------
        >>> import numpy as np
        >>> from repro_torch.compiler import compile_bank
        >>> bank = np.zeros((3, 15), np.int64)
        >>> bank[:, 7] = [64, 96, 160]
        >>> prog = compile_bank(bank)
        >>> sub = prog.select([2, 0])
        >>> sub.n_filters, [int(w) for w in sub.qbank[:, 7]]
        (2, [160, 64])
        >>> prog.select([2, 0]) is sub               # memoized
        True
        """
        rows = np.asarray(rows, np.int64)
        memo = rows.tobytes()
        if memo in self._subprograms:
            return self._subprograms[memo]
        qbank = np.ascontiguousarray(self.qbank[rows])
        packed = np.ascontiguousarray(self.packed[rows])
        qkey = _qbank_key(qbank, self.spec)
        pkey = _packed_key(packed, self.taps, self.spec.sample_bits)
        sub = PROGRAM_CACHE.get(pkey)
        if sub is None:
            sub = BlmacProgram(
                qbank=qbank,
                exponents=np.ascontiguousarray(self.exponents[rows]),
                packed=packed,
                occupancy=np.ascontiguousarray(self.occupancy[rows]),
                signatures=np.ascontiguousarray(self.signatures[rows]),
                pulse_counts=np.ascontiguousarray(self.pulse_counts[rows]),
                spec=self.spec,
                key=pkey[1].hex(),
            )
            PROGRAM_CACHE.put(sub, pkey, qkey)
        _memo_put(self._subprograms, memo, sub, SUBPROGRAM_MEMO_MAX)
        return sub

    # -- cost-model reads ----------------------------------------------------

    def machine_cycles(self, spec=None) -> np.ndarray:
        """(B,) §4 machine clock cycles per output sample, per filter.

        Derived from the program's own digits (no CSD recomputation):
        layers are sliced or padded to ``spec.n_layers`` — exact, because
        NAF digit values do not depend on the requested width — and a
        bank whose digits populate layers the spec lacks raises, as
        `machine_cycles_batch` would.  Memoized per spec parameters (the
        memo is no part of the key or the file); equal to both
        simulators' cycles (`tests/torch_differential.py`).
        """
        if spec is None:
            spec = MachineSpec(taps=self.taps)
        if spec.taps != self.taps:
            raise ValueError(
                f"spec is for {spec.taps} taps, bank has {self.taps}"
            )
        key = (spec.n_layers, spec.start_overhead, spec.fused_last_add)
        if key not in self._cycle_cache:
            _bump("machine_cycle_computes")
            digits = self.half_digits()  # (B, M, L) LSB-first
            n = int(spec.n_layers)
            if digits.shape[-1] > n:
                if self.occupancy[:, n:].any():
                    raise ValueError(
                        f"bank populates CSD layer >= {n}; spec has only "
                        f"{n} layers"
                    )
                digits = digits[..., :n]
            elif digits.shape[-1] < n:
                pad = np.zeros(
                    digits.shape[:-1] + (n - digits.shape[-1],), np.int8
                )
                digits = np.concatenate([digits, pad], axis=-1)
            cycles = code_count_batch(digits) + spec.start_overhead
            if spec.fused_last_add:
                cycles = cycles - np.count_nonzero(
                    digits.any(axis=1), axis=-1
                )
            cycles.setflags(write=False)  # shared cache entry: no mutation
            self._cycle_cache[key] = cycles
        return self._cycle_cache[key]

    def predict_specialized_us(self, channels: int, n_tiles: int, cal=None,
                               tile: int = 1) -> float:
        """Modelled per-dispatch latency of the specialized path
        (`repro_torch.core.costmodel.predict_specialized_us` with the
        bank's inputs read off the program); ``cal`` selects the lane's
        constants (default: the reference's), ``tile`` the outputs a
        signal tile holds (the ``"cuda"`` lane prices every output)."""
        from ..core.costmodel import predict_specialized_us

        return predict_specialized_us(
            self.n_filters, channels, n_tiles, self.taps,
            self.mean_pulses, self.n_layers, cal=cal, tile=tile,
            max_pulses=float(self.pulse_counts.max(initial=0)),
        )

    def predict_scheduled_us(
        self,
        channels: int,
        n_tiles: int,
        tile: int,
        bank_tile: int | None = None,
        merge: int | None = None,
        cal=None,
    ) -> float:
        """Modelled per-dispatch latency of the scheduled bank path for
        one geometry, costed on the memoized schedule.  On the reference
        lane the reference's formula, with ``f32_safe`` decided by the
        schedule's superlayers (`f32_dot_safe`); on the ``"cuda"`` lane
        K1's term walk and output bytes (`predict_bank_kernel_us`)."""
        from ..core.costmodel import (CUDA_LANE, predict_bank_kernel_us,
                                      predict_scheduled_us)
        from ..kernels.blmac_fir import bank_k, bank_work, f32_dot_safe

        sched = self.schedule(bank_tile, merge)
        if cal is not None and cal.lane == CUDA_LANE:
            return predict_bank_kernel_us(
                self.n_filters, channels, n_tiles * tile, bank_k(self.taps),
                bank_work(sched, self.spec.sample_bits), cal,
            )
        m_pad = self.n_words * TRITS_PER_WORD
        f32_safe = all(
            f32_dot_safe(m_pad, parts)
            for g in sched.groups
            for _, parts in g.schedule
        )
        return predict_scheduled_us(
            channels, n_tiles, tile, m_pad,
            sched.group_summaries(), cal=cal, f32_safe=f32_safe,
        )

    # -- serialization -------------------------------------------------------

    def save(self, path) -> None:
        """Write the program to ``path``: one npz holding the arrays plus
        a JSON header (format version, geometry, content key), atomically
        — the reference's format, so either package loads the file."""
        header = {
            "format_version": PROGRAM_FORMAT_VERSION,
            "kind": "blmac_program",
            "key": self.key,
            "n_filters": self.n_filters,
            "taps": self.taps,
            "n_layers": self.n_layers,
            "n_words": self.n_words,
            "spec": {
                "coeff_bits": self.spec.coeff_bits,
                "sample_bits": self.spec.sample_bits,
                "n_layers": self.spec.n_layers,
            },
        }
        atomic_write(path, lambda f: np.savez(
            f,
            header=np.array(json.dumps(header)),
            qbank=self.qbank,
            exponents=self.exponents,
            packed=self.packed,
        ))

    @classmethod
    def load(cls, path) -> "BlmacProgram":
        """Read a program written by `save` (in either package).

        Every way the file can be bad raises `ProgramFormatError`: another
        format version, an unreadable archive, a header digest that does
        not match the packed trits, coefficients that do not decode from
        the trits, or (for a file with a ``cse`` header section, which
        loads as an `OptimizedProgram`) a combine matrix that does not
        rebuild the parent under its stored key.  The loaded program is
        registered content-addressed.
        """
        try:
            with np.load(path, allow_pickle=False) as z:
                header = json.loads(str(z["header"][()]))
                check_format_header(
                    header, kind="blmac_program",
                    version=PROGRAM_FORMAT_VERSION, path=path,
                    error_cls=ProgramFormatError, label="BLMAC program",
                )
                qbank = np.ascontiguousarray(z["qbank"], np.int64)
                exponents = np.ascontiguousarray(z["exponents"], np.int64)
                packed = np.ascontiguousarray(z["packed"], np.uint32)
                combine = use_counts = None
                if "cse" in header:  # an optimized program (optimize.py)
                    combine = np.asarray(z["combine"], np.int64)
                    use_counts = np.asarray(z["use_counts"], np.int64)
        except ProgramFormatError:
            raise
        except Exception as e:  # truncated zip, missing array, bad JSON …
            raise ProgramFormatError(f"{path}: unreadable program file: {e}")
        spec = CompileSpec(**header["spec"])
        pkey = _packed_key(packed, int(header["taps"]), spec.sample_bits)
        # an optimized file's `key` is its CSE content address; the trit
        # digest moves to `packed_digest` (the same integrity check)
        if pkey[1].hex() != header.get("packed_digest", header.get("key")):
            raise ProgramFormatError(
                f"{path}: content digest mismatch (corrupted file?)"
            )
        if "cse" in header:
            from .optimize import _load_optimized

            try:
                _check_decodes(qbank, packed)
            except ValueError as e:
                raise ProgramFormatError(f"{path}: {e}") from e
            return _load_optimized(path, header, qbank, exponents, packed,
                                   combine, use_counts)
        try:
            return _register(qbank, exponents, packed, spec, pkey)
        except ValueError as e:
            raise ProgramFormatError(f"{path}: {e}") from e


def _check_decodes(qbank: np.ndarray, packed: np.ndarray) -> None:
    """The digest covers the packed trits; the stored coefficients must
    decode from them, or the oracle and the kernels would diverge."""
    half = qbank.shape[-1] // 2
    halves = csd_decode(np.swapaxes(unpack_trits(packed, half + 1), 1, 2))
    if not np.array_equal(
        qbank, np.concatenate([halves, halves[:, :-1][:, ::-1]], axis=1)
    ):
        raise ValueError(
            "stored coefficients do not decode from the packed trits"
        )


def _from_arrays(
    qbank: np.ndarray,
    exponents: np.ndarray,
    packed: np.ndarray,
    spec: CompileSpec,
) -> BlmacProgram:
    """Assemble a program from its stored arrays — derives only the cheap
    views (occupancy, signatures, pulse counts read off the packed words),
    never re-runs CSD encoding."""
    taps = qbank.shape[-1]
    require_type1(qbank, "compile_bank")
    assert_int32_bound(qbank, spec.sample_bits, "compile_bank")
    occupancy = np.ascontiguousarray(packed.any(axis=-1))
    return BlmacProgram(
        qbank=qbank,
        exponents=np.ascontiguousarray(exponents),
        packed=packed,
        occupancy=occupancy,
        signatures=np.ascontiguousarray(occupancy_signatures(occupancy)),
        pulse_counts=packed_pulse_counts(packed),
        spec=spec,
        key=_packed_key(packed, taps, spec.sample_bits)[1].hex(),
    )


def _register(qbank, exponents, packed, spec, pkey) -> BlmacProgram:
    """Check stored arrays, then return the cached program for their
    digest or build and register a new one."""
    _check_decodes(qbank, packed)
    cached = PROGRAM_CACHE.get(pkey)
    if cached is not None:
        return cached
    prog = _from_arrays(qbank, exponents, packed, spec)
    PROGRAM_CACHE.put(prog, pkey, _qbank_key(qbank, spec))
    return prog


def program_from_arrays(
    qbank, exponents, packed, spec: CompileSpec | None = None, *,
    combine=None, use_counts=None, level=2,
) -> BlmacProgram:
    """Build a program from another package's arrays — the reference's
    ``BlmacProgram.qbank``, ``.exponents`` and ``.packed`` as numpy
    arrays — without re-running CSD encoding.  The result carries the
    same content key as the program the arrays came from (pass that
    program's ``spec`` fields when they differ from the defaults).

    With ``combine`` and ``use_counts`` (an optimized program's arrays,
    its ``level`` beside them) the arrays describe the augmented bank of a
    CSE-optimized program, and ``spec`` is its parent's: the parent is
    rebuilt by linearity and the result is an `OptimizedProgram` under the
    reference's key for the same pass.

    Raises ``ValueError`` when the coefficients do not decode from the
    packed trits, are not type-I, or break the §2.1 int32 bound (the
    parent's, for an optimized program).
    """
    spec = spec or CompileSpec()
    if combine is not None:
        from .optimize import _rebuild_optimized

        qbank = np.ascontiguousarray(np.asarray(qbank), np.int64)
        packed = np.ascontiguousarray(np.asarray(packed), np.uint32)
        _check_decodes(qbank, packed)
        return _rebuild_optimized(
            qbank, np.ascontiguousarray(np.asarray(exponents), np.int64),
            packed, np.asarray(combine), np.asarray(use_counts), level, spec)
    qbank = np.ascontiguousarray(np.asarray(qbank), np.int64)
    packed = np.ascontiguousarray(np.asarray(packed), np.uint32)
    exponents = np.ascontiguousarray(np.asarray(exponents), np.int64)
    if qbank.ndim != 2 or packed.ndim != 3 or \
            packed.shape[0] != qbank.shape[0]:
        raise ValueError(
            f"qbank {qbank.shape} and packed {packed.shape} do not describe "
            f"one bank"
        )
    pkey = _packed_key(packed, qbank.shape[-1], spec.sample_bits)
    return _register(qbank.copy(), exponents.copy(), packed.copy(), spec,
                     pkey)


def compile_bank(coeffs, spec: CompileSpec | None = None) -> BlmacProgram:
    """Compile a filter bank to a `BlmacProgram`.

    Content-addressed: the same bank compiles once per process; every
    engine and entry point shares the artifact and its memoized
    schedules.

    Parameters
    ----------
    coeffs : (B, taps) or (taps,) array
        Odd symmetric type-I coefficients.  Float input is quantized
        per-row the paper's way (§3.2, `po2_quantize_batch` at
        ``spec.coeff_bits``); integer input is taken as already quantized.
    spec : CompileSpec | None
        Compilation parameters; part of the content address.

    Raises
    ------
    ValueError
        Coefficients are not type-I, or the §2.1 int32 accumulator bound
        fails at ``spec.sample_bits``.
    TypeError
        Coefficient dtype is neither float nor integer.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.compiler import compile_bank
    >>> bank = np.zeros((2, 15), np.int64)
    >>> bank[:, 7] = [64, 96]                    # centre-tap scalers
    >>> prog = compile_bank(bank)
    >>> prog.n_filters, prog.taps
    (2, 15)
    >>> compile_bank(bank) is prog               # content-addressed
    True
    """
    spec = spec or CompileSpec()
    with span("compile.lookup"):
        coeffs = np.atleast_2d(np.asarray(coeffs))
        if coeffs.ndim != 2:
            raise ValueError("coeffs must be (n_filters, taps)")
        if coeffs.dtype.kind == "f":
            from ..core.quantize import po2_quantize_batch

            qbank, exponents = po2_quantize_batch(coeffs, spec.coeff_bits)
            exponents = np.ascontiguousarray(exponents, np.int64)
        elif coeffs.dtype.kind in "iu":
            qbank = coeffs.astype(np.int64)
            exponents = np.zeros(qbank.shape[0], np.int64)
        else:
            raise TypeError(
                f"cannot compile coefficients of dtype {coeffs.dtype}")
        qbank = np.ascontiguousarray(qbank)
        qkey = _qbank_key(qbank, spec)
        prog = PROGRAM_CACHE.get(qkey)
    if prog is not None:
        return prog
    with span("build.program"):
        require_type1(qbank, "compile_bank")
        assert_int32_bound(qbank, spec.sample_bits, "compile_bank")
        digits = _bank_digits(qbank, spec.n_layers)  # (B, M, L) — once
        packed = pack_trits(np.swapaxes(digits, 1, 2))  # (B, L, n_words)
        pkey = _packed_key(packed, qbank.shape[-1], spec.sample_bits)
        # a bank first seen through `compile_packed` is registered under its
        # packed digest only: adopt that program, index it under this key too
        existing = PROGRAM_CACHE.get(pkey)
        if existing is not None:
            PROGRAM_CACHE.put(existing, qkey)
            return existing
        _bump("bank_compiles")
        occupancy = np.ascontiguousarray(layer_occupancy(digits))
        prog = BlmacProgram(
            qbank=qbank,
            exponents=exponents,
            packed=packed,
            occupancy=occupancy,
            signatures=np.ascontiguousarray(occupancy_signatures(occupancy)),
            pulse_counts=np.count_nonzero(digits, axis=(1, 2)).astype(np.int64),
            spec=spec,
            key=pkey[1].hex(),
        )
        prog._half_digits = np.ascontiguousarray(digits)
        prog._half_digits.setflags(write=False)
        PROGRAM_CACHE.put(prog, qkey, pkey)
        return prog


def compile_packed(
    packed: np.ndarray, taps: int, sample_bits: int = 8
) -> BlmacProgram:
    """Wrap an existing packed-trit operand as a `BlmacProgram` without
    re-running CSD encoding: the quantized coefficients are decoded from
    the trits (exact — the trit words are the weights)."""
    packed = np.ascontiguousarray(np.asarray(packed, np.uint32))
    if packed.ndim != 3:
        raise ValueError("packed must be (n_filters, n_layers, n_words)")
    pkey = _packed_key(packed, int(taps), sample_bits)
    prog = PROGRAM_CACHE.get(pkey)
    if prog is not None:
        return prog
    with span("build.program"):
        _bump("bank_compiles")
        # own (and freeze) a copy, never the caller's buffer
        packed = packed.copy()
        half = int(taps) // 2
        halves = csd_decode(np.swapaxes(unpack_trits(packed, half + 1), 1, 2))
        qbank = np.ascontiguousarray(
            np.concatenate([halves, halves[:, :-1][:, ::-1]], axis=1)
        )
        spec = CompileSpec(sample_bits=sample_bits, n_layers=packed.shape[1])
        prog = _from_arrays(
            qbank, np.zeros(qbank.shape[0], np.int64), packed, spec
        )
        PROGRAM_CACHE.put(prog, pkey, _qbank_key(qbank, spec))
        return prog

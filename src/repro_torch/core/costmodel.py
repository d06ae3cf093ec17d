"""The paper's cost model (§3.3, §4) and the bank-dispatch cost model.

The paper's counts, numpy copies of `repro.core.costmodel`'s: the
additions needed to apply a type-I FIR filter with a BLMAC, with the
symmetric pre-add of Eq. 3,

    tot = N/2                              (pre-adds of symmetric samples)
        + Σ_{j<N/2+1} ntrits[|w_j|]        (BLMAC pulses)

(`fir_blmac_additions`, per coefficient and per tap, and the classical
baseline the paper compares with), and the §4 machine's clock cycles per
output sample, one per RLE code plus a fixed overhead (`machine_cycles`,
`machine_cycles_batch`).

The bank-dispatch cost model is the objective the dispatch planner
(`repro_torch.kernels.runtime.autotune_bank_dispatch`) minimises.

A copy of the reference's model (`repro.core.costmodel`) with one lane
added.  Coarse per-dispatch latency predictions in microseconds, from a
per-lane constant table (`BackendCalibration`):

  * ``"interpret"`` — the reference's constant set, byte for byte, and its
    formulas unchanged: one dispatch per tile group and one matmul per
    superlayer (`predict_scheduled_us`), one dispatch per filter and
    channel (`predict_specialized_us`), one dense GEMM for the CSE fold
    (`predict_combine_us`).  A planner on the CPU uses it, so its plans
    equal the reference's ``compiled=False`` plans field for field.
  * ``"cuda"`` — what the port's kernels do on the card, with constants
    fitted there by `calibrate_backend` (CUDA-event probes of the port's
    own kernels, keyed on ``torch.cuda.get_device_name()``):

      - the bank kernel K1 (`predict_bank_kernel_us`): one launch for every
        tile group; each 64-row tile walks its group's Horner terms (digit
        run × sample byte plane), one int8 wgmma of 64 × K × outputs each;
        its output rows written once, which bounds it at large sizes; at
        small ones the longest walk of one job sets its time;
      - the specialized kernel K2 (`predict_specialized_us`): one launch
        for every filter and channel; a fold per tap and an IMAD per pulse
        for every output, over all of them at large sizes, and at small
        ones the walk of the longest filter, which one thread makes;
      - the combine fold (`predict_combine_us`): one launch, the real rows
        read and written and the shared rows read, one step per entry of
        its table (pairs of real rows, each entry a shared row either
        uses) for every output.

    Each is priced as the time a caller that waits for the result pays
    per call: a constant per launch (the host's call and the kernel's
    latency) plus the kernel's bytes and operations at fitted rates.

There is no fallback: `ensure_calibration` fits the ``"cuda"`` lane at
first use and raises when a probe fails, and no other lane is fitted.
"""
from __future__ import annotations

import importlib
import json
import os
import time
from dataclasses import asdict, dataclass

import numpy as np

from .csd import csd_digits, num_pulses
from .rle import code_count, code_count_batch

__all__ = [
    "adds_per_coeff",
    "adds_per_tap",
    "classical_equivalent_adds",
    "fir_blmac_additions",
    "fir_blmac_additions_batch",
    "machine_cycles",
    "machine_cycles_batch",
    "BackendCalibration",
    "BankDispatchPlan",
    "CUDA_LANE",
    "REFERENCE_CALIBRATIONS",
    "calibrate_backend",
    "calibration_path",
    "ensure_calibration",
    "get_calibration",
    "predict_bank_kernel_us",
    "predict_combine_us",
    "predict_scheduled_us",
    "predict_specialized_us",
]

def _half(wq: np.ndarray) -> np.ndarray:
    """First N//2 + 1 coefficients of a type-I (odd, symmetric) filter."""
    n = wq.shape[-1]
    if n % 2 == 0:
        raise ValueError("type-I FIR filters have an odd number of taps")
    return wq[..., : n // 2 + 1]


def fir_blmac_additions(wq: np.ndarray) -> int:
    """Total additions to apply one quantized N-tap type-I filter (Eq. 3)."""
    n = wq.shape[-1]
    return int(n // 2 + num_pulses(np.abs(_half(wq))).sum())


def fir_blmac_additions_batch(wq: np.ndarray) -> np.ndarray:
    """Vectorized over a bank: ``wq`` is (n_filters, n_taps) int."""
    n = wq.shape[-1]
    return n // 2 + num_pulses(np.abs(_half(wq))).sum(axis=-1)


def adds_per_coeff(total_adds, n_taps: int):
    """(B_N − N/2) / (N/2 + 1) — comparable to Tab. 3's per-weight averages."""
    return (np.asarray(total_adds, np.float64) - n_taps // 2) / (n_taps // 2 + 1)


def adds_per_tap(total_adds, n_taps: int):
    return np.asarray(total_adds, np.float64) / n_taps


def classical_equivalent_adds(n_taps: int, mult_cost_adds: int = 15) -> int:
    """The paper's apples-to-apples baseline: symmetric classical algorithm
    = (N/2+1) multiplications (@ ``mult_cost_adds`` adds each for 16-bit)
    + N−1 additions."""
    return mult_cost_adds * (n_taps // 2 + 1) + n_taps - 1


def machine_cycles(
    wq: np.ndarray, n_layers: int = 16, overhead: int = 0
) -> int:
    """Clock cycles of the §4 dot-product machine for one output sample:
    one cycle per RLE code (pulse or EOR) + fixed per-sample overhead."""
    digits = csd_digits(_half(wq), n_digits=n_layers)
    return code_count(digits) + overhead


def machine_cycles_batch(
    wq: np.ndarray,
    n_layers: int = 16,
    overhead: int = 0,
    fused_last_add: bool = False,
) -> np.ndarray:
    """Vectorized :func:`machine_cycles` over a (B, taps) bank → (B,) int64.

    ``fused_last_add`` applies the §4 optimization (the last add of each
    non-empty bit layer overlaps the shift: −1 cycle per such layer, −16
    for a fully-populated 16-layer program) — matching both simulators.
    """
    wq2 = np.atleast_2d(np.asarray(wq, np.int64))
    digits = csd_digits(_half(wq2), n_digits=n_layers)  # (B, M, L)
    cycles = code_count_batch(digits) + overhead
    if fused_last_add:
        cycles = cycles - np.count_nonzero(digits.any(axis=1), axis=-1)
    return cycles


# the reference's "interpret" constants (microseconds)
SPEC_CALL_US = 140.0  # per specialized-program dispatch (B=1 pallas_call)
SPEC_OP_US = 0.014  # per pulse/fold/shift op, per signal tile
PALLAS_CALL_US = 500.0  # per scheduled-bank pallas_call dispatch
STEP_US = 300.0  # per grid step: frame gather + interpret plumbing
MAC_US = 7e-5  # per int32 multiply-accumulate in a superlayer matmul
UNPACK_US = 2e-3  # per packed trit unpacked, per grid step

CUDA_LANE = "cuda"


@dataclass(frozen=True)
class BackendCalibration:
    """Per-lane cost-model constants (all microseconds).

    The reference's fields keep their meaning on the ``"interpret"`` lane.
    On the ``"cuda"`` lane:

    * ``call_us`` / ``walk_us`` / ``byte_us`` / ``mac_us`` — K1: per
      launch, per term × 32-deep k-step of its longest job, per byte of
      its output, per int8 multiply-accumulate of its term walk;
    * ``spec_call_us`` / ``spec_walk_us`` / ``spec_op_us`` — K2: per
      launch, per add a thread makes for the longest filter (its outputs
      a thread × the filter's folds and pulses, over its segments on a
      small grid), per add (fold or pulse) of every output; ``sms``, the
      card's SMs, decides the outputs a thread and the segments
      (`repro_torch.kernels.blmac_fir.specialized_walk`);
    * ``fold_call_us`` / ``fold_byte_us`` / ``fold_op_us`` — the combine
      fold: per launch, per byte it moves, per table entry an output
      (two multiply-adds: a pair of rows);
    * ``step_us``, ``unpack_us``, ``mac_f32_us`` — unused (0).

    ``source`` is ``"reference"`` (shipped constants) or ``"fitted"``
    (measured by `calibrate_backend`; ``device_name`` names the card).
    """

    lane: str
    spec_call_us: float
    spec_op_us: float
    call_us: float
    step_us: float
    mac_us: float
    unpack_us: float
    mac_f32_us: float = 0.0
    walk_us: float = 0.0
    byte_us: float = 0.0
    spec_walk_us: float = 0.0
    sms: int = 0
    fold_call_us: float = 0.0
    fold_byte_us: float = 0.0
    fold_op_us: float = 0.0
    source: str = "reference"
    device_name: str = ""


REFERENCE_CALIBRATIONS: "dict[str, BackendCalibration]" = {
    "interpret": BackendCalibration(
        "interpret", SPEC_CALL_US, SPEC_OP_US, PALLAS_CALL_US, STEP_US,
        MAC_US, UNPACK_US,
    ),
}


@dataclass(frozen=True)
class BankDispatchPlan:
    """The planner's verdict: how to run a (B, taps) bank over C channels.

    ``mode`` is ``"specialized"`` (K2, the filters' pulse lists) or
    ``"scheduled"`` (K1 over occupancy-grouped bank tiles); ``lane`` the
    constant set the plan was priced with (``"interpret"`` or
    ``"cuda"``); ``merge`` the CSD layers fused per superlayer;
    ``predicted_us`` the modelled per-dispatch latency the plan won with.
    ``cse`` is ``""`` for a plain program, ``"optimized"`` when the
    shared-row layout of an optimized program won, ``"declined"`` when its
    parent's own plan was cheaper once the fold was priced in (the engine
    then runs the parent, with the same outputs).
    """

    mode: str
    tile: int
    bank_tile: int
    merge: int
    predicted_us: float
    lane: str = "interpret"
    cse: str = ""


def _lane(cal: BackendCalibration | None) -> BackendCalibration:
    return cal or REFERENCE_CALIBRATIONS["interpret"]


def predict_specialized_us(
    n_filters: int,
    channels: int,
    n_tiles: int,
    taps: int,
    mean_pulses: float,
    n_layers: int = 16,
    cal: BackendCalibration | None = None,
    tile: int = 1,
    max_pulses: float | None = None,
) -> float:
    """Modelled latency of the specialized path.  Reference lane: one
    dispatch per (filter, channel), each ~(folds + pulses + layer shifts)
    vector ops per signal tile.  ``"cuda"`` lane: K2's one launch for all
    filters and channels, a fold per tap and an IMAD per pulse for each of
    the ``n_tiles · tile`` outputs (no shifts: a pulse's shift is its
    multiplier), plus one thread's walk over the longest filter
    (``max_pulses``, default ``mean_pulses``) for its outputs, a segment
    of it on a small grid (`repro_torch.kernels.blmac_fir.
    specialized_walk`)."""
    c = _lane(cal)
    if c.lane == CUDA_LANE:
        adds = n_filters * channels * n_tiles * tile * (taps // 2 + mean_pulses)
        walk = _kernels().specialized_walk(
            n_filters, channels, n_tiles, tile, c.sms, taps,
            mean_pulses if max_pulses is None else max_pulses)
        return c.spec_call_us + walk * c.spec_walk_us + adds * c.spec_op_us
    ops = taps // 2 + mean_pulses + n_layers
    return n_filters * channels * (
        c.spec_call_us + n_tiles * ops * c.spec_op_us
    )


def predict_scheduled_us(
    channels: int,
    n_tiles: int,
    tile: int,
    m_pad: int,
    groups: "list[tuple[int, int, int, int]]",
    cal: BackendCalibration | None = None,
    f32_safe: bool = False,
) -> float:
    """The reference's model of the scheduled bank path.

    ``groups`` summarizes a `BankSchedule`: one ``(n_bank_tiles,
    bank_tile, n_superlayers, n_sel_layers)`` tuple per tile group.  Cost
    per grid step = fixed step overhead + one matmul per superlayer + the
    unpack of the tile's selected trit layers; one dispatch per group
    with populated layers.  ``f32_safe`` prices MACs at the lane's
    ``mac_f32_us`` when it has one.  The ``"cuda"`` lane prices K1 with
    `predict_bank_kernel_us` instead (`BlmacProgram.predict_scheduled_us`
    chooses)."""
    c = _lane(cal)
    if c.lane == CUDA_LANE:
        raise ValueError("the cuda lane prices K1 with predict_bank_kernel_us")
    mac = (c.mac_f32_us or c.mac_us) if f32_safe else c.mac_us
    total = 0.0
    for n_bank_tiles, bank_tile, n_super, n_sel in groups:
        if n_sel == 0:
            continue  # zero-fill group: no kernel dispatched
        step = (
            c.step_us
            + n_super * bank_tile * m_pad * tile * mac
            + n_sel * bank_tile * m_pad * c.unpack_us
        )
        total += c.call_us + n_bank_tiles * channels * n_tiles * step
    return total


def predict_bank_kernel_us(
    n_rows: int,
    channels: int,
    n_outputs: int,
    k: int,
    tile_terms: "list[tuple[int, int]]",
    cal: BackendCalibration,
) -> float:
    """Modelled latency of one K1 launch (``"cuda"`` lane).

    ``tile_terms`` holds one ``(n_row_tiles, n_terms)`` pair per tile
    group (`repro_torch.kernels.blmac_fir.bank_work`): every 64-row tile
    of a group walks its terms, each an int8 product of 64 rows × ``k``
    folded taps × ``channels · n_outputs`` samples; one job (64 rows × 128
    outputs) walks its group's terms in turn, ``k / 32`` steps each.  The
    ``n_rows`` output rows are written once."""
    macs = sum(t * n for t, n in tile_terms) * 64 * k * channels * n_outputs
    walk = max((n for _, n in tile_terms), default=0) * k // 32
    out_bytes = 4 * n_rows * channels * n_outputs
    return (cal.call_us + walk * cal.walk_us + out_bytes * cal.byte_us
            + macs * cal.mac_us)


def predict_combine_us(
    n_real: int,
    n_shared: int,
    channels: int,
    n_tiles: int,
    tile: int,
    cal: BackendCalibration | None = None,
    nnz: int | None = None,
    entries: int | None = None,
) -> float:
    """Modelled latency of the CSE combine stage; zero without shared
    rows.  Reference lane: one dispatch plus an (n_real, n_shared) int32
    GEMM over the signal.  ``"cuda"`` lane: the fold kernel's launch, its
    bytes (each real row read and written, each shared row read) and one
    step per entry of its table (``entries``: a pair of real rows' shared
    rows, padding included, `CombineLayout.entries`; by default ``nnz``,
    the combine matrix's nonzeros), for every one of the ``channels ·
    n_tiles · tile`` outputs."""
    if n_shared == 0:
        return 0.0
    c = _lane(cal)
    signal = channels * n_tiles * tile
    if c.lane == CUDA_LANE:
        work = nnz if entries is None else entries
        if work is None:
            raise ValueError("the cuda lane prices the fold by its table's "
                             "entries or the matrix's nonzeros")
        nbytes = 4 * signal * (2 * n_real + n_shared)
        return (c.fold_call_us + nbytes * c.fold_byte_us
                + work * signal * c.fold_op_us)
    return c.call_us + n_real * (n_shared + 1) * signal * c.mac_us


# ---------------------------------------------------------------------------
# mesh-aware sharded-bank cost model (the reference's, unchanged)
# ---------------------------------------------------------------------------
#
# Critical path over two resources: the slowest shard's device time
# (shards on disjoint devices run concurrently) and the host's total
# dispatch time (one thread feeds the whole mesh, so per-shard host work
# sums), plus one queue hop per shard and, for time-sharded streams, one
# halo exchange per data slot.  `SHARD_DISPATCH_US` and `HALO_EXCHANGE_US`
# are the reference's priors on every lane: nothing fits them on the card
# yet, and the model assumes distinct devices — slots that share a card
# run one after another there, which the maximum does not see.

SHARD_DISPATCH_US = 250.0  # per bank-shard program dispatch, per push
HALO_EXCHANGE_US = 180.0  # per time-shard halo exchange, per push


@dataclass(frozen=True)
class ShardedBankPlan:
    """The mesh-aware planner's verdict for one bank on one (bank, data)
    mesh.  ``n_bank_shards`` of 1 means the planner declined to shard the
    filter axis; ``data_mode`` is ``"none"`` (data axis idle),
    ``"channels"`` (C split over the axis) or ``"time"`` (signal slices
    with a halo exchange); ``shard_plans`` holds one `BankDispatchPlan`
    per bank shard; ``predicted_us`` is the modelled critical path;
    ``cse`` as in `BankDispatchPlan`."""

    n_bank_shards: int
    n_data: int
    data_mode: str
    shard_plans: tuple
    predicted_us: float
    cse: str = ""

    @property
    def sharded(self) -> bool:
        return self.n_bank_shards > 1 or self.n_data > 1


def predict_sharded_us(shard_us, n_data: int = 1, data_mode: str = "none",
                       host_us=None) -> float:
    """Critical-path latency of a sharded dispatch: the largest per-shard
    device prediction or the sum of the per-shard host costs, whichever
    is larger, plus `SHARD_DISPATCH_US` a shard and, for a time-sharded
    row, `HALO_EXCHANGE_US` a data slot."""
    shard_us = list(shard_us)
    if not shard_us:
        raise ValueError("predict_sharded_us needs at least one shard")
    n_shards = len(shard_us)
    us = max(shard_us)
    if host_us is not None:
        us = max(us, float(sum(host_us)))
    us += n_shards * SHARD_DISPATCH_US
    if data_mode == "time" and n_data > 1:
        us += HALO_EXCHANGE_US * n_data
    return us


# The recovery target's price (the reference's constants): a one-time bill
# for the candidate's fresh shard schedules and the in-flight replay,
# against its steady-state push latency over an amortization horizon.
# They rank candidates; they do not predict wall time.
RECOVERY_REPLAN_US = 2500.0  # per fresh shard subprogram: select + schedule
REPLAY_US_PER_SAMPLE = 0.5  # per in-flight output sample replayed
RECOVERY_HORIZON_PUSHES = 50.0  # pushes the recovered mesh amortizes over


def predict_recovery_us(steady_us: float, n_replanned_shards: int,
                        replay_samples: int) -> float:
    """Modelled total cost of adopting one recovery target: re-planning
    ``n_replanned_shards`` shard schedules, replaying ``replay_samples``
    in-flight output samples, and ``steady_us`` a push over
    `RECOVERY_HORIZON_PUSHES`.  Lower is better."""
    return (
        n_replanned_shards * RECOVERY_REPLAN_US
        + replay_samples * REPLAY_US_PER_SAMPLE
        + RECOVERY_HORIZON_PUSHES * float(steady_us)
    )


# ---------------------------------------------------------------------------
# the "cuda" lane's fit
# ---------------------------------------------------------------------------

def calibration_path() -> str:
    """Where fitted constants persist: ``calibration.json`` under
    ``$REPRO_TORCH_CACHE_DIR`` (default ``~/.cache/repro-torch-blmac``),
    so a process fits once per card, not once per run."""
    root = os.environ.get(
        "REPRO_TORCH_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "repro-torch-blmac"),
    )
    return os.path.join(root, "calibration.json")


def _load_table() -> dict:
    try:
        with open(calibration_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device)


def get_calibration(lane: str, device=None) -> BackendCalibration | None:
    """The constants of ``lane``: the reference's for ``"interpret"``;
    for ``"cuda"`` the fitted entry of `calibration_path()` keyed on the
    name of ``device`` (a CUDA device), or None when there is none.
    Never runs probes."""
    if lane in REFERENCE_CALIBRATIONS:
        return REFERENCE_CALIBRATIONS[lane]
    if lane != CUDA_LANE:
        raise ValueError(f"unknown lane {lane!r}; expected 'interpret' or "
                         f"'{CUDA_LANE}'")
    entry = _load_table().get(lane, {}).get(_device_name(device))
    if entry is None:
        return None
    try:
        return BackendCalibration(**entry)
    except TypeError:  # a file of another layout: fit again
        return None


def ensure_calibration(lane: str, device=None) -> BackendCalibration:
    """`get_calibration`, fitting the ``"cuda"`` lane on ``device`` at
    first use (`calibrate_backend`).  A failed probe raises: the card's
    plans are never priced with constants that were not measured there."""
    cal = get_calibration(lane, device)
    return cal if cal is not None else calibrate_backend(lane, device)


def _fit(rows: "list[list[float]]", times: "list[float]") -> np.ndarray:
    """Least squares ``times ≈ rows @ coef`` with ``coef >= 0``: a column
    whose coefficient comes out negative is dropped (set to 0) and the
    rest refitted."""
    a = np.asarray(rows, np.float64)
    t = np.asarray(times, np.float64)
    scale = np.linalg.norm(a, axis=0)  # the columns differ by 10 decades
    scale[scale == 0] = 1.0
    a = a / scale
    keep = np.ones(a.shape[1], bool)
    while True:
        coef = np.zeros(a.shape[1])
        coef[keep] = np.linalg.lstsq(a[:, keep], t, rcond=None)[0]
        if (coef >= 0).all():
            return coef / scale
        keep &= coef > 0


def _spin_cycles(fn, reps: int) -> int:
    """GPU clocks of spin that keep the device busy while the host
    enqueues ``reps`` calls of ``fn``: about twice their time at about
    2 GHz (one synchronised call timed), plus 1 ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return int(min(4e9 * reps * (time.perf_counter() - t0) + 2e6, 2**31 - 1))


def _batch_us(fn, reps: int, spin: int) -> tuple[float, float]:
    """One batch of ``reps`` calls of ``fn`` queued behind a GPU spin of
    ``spin`` clocks, so the host enqueues the whole batch before the
    device starts it: the host's microseconds a call (its clock around
    the enqueues) and the device's (CUDA events around the batch, run back
    to back)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / reps * 1e3


def _split_us(fn, reps: int, batches: int = 3) -> tuple[float, float]:
    """``fn``'s cost a call split in two (`_batch_us`), each the least
    over ``batches`` batches of ``reps`` calls."""
    spin = _spin_cycles(fn, reps)
    host, device = zip(*(_batch_us(fn, reps, spin) for _ in range(batches)))
    return min(host), min(device)


# probe shapes: (filters, taps, outputs) for K1 and K2; (real rows, shared
# rows, nonzeros a row, outputs) for the fold.  They vary the launch's
# fixed cost, the bytes and the operations independently, from one filter
# to the sweep's sizes.
BANK_PROBES = ((1, 63, 4096), (1, 127, 4096), (32, 63, 4096),
               (256, 63, 4096), (256, 63, 16384), (1024, 127, 16384),
               (64, 255, 4096))
SPEC_PROBES = ((1, 63, 4096), (1, 127, 4096), (32, 63, 4096),
               (256, 63, 4096), (64, 127, 4096), (8, 127, 16384))
# fold probes with clustered columns (the last field 1: rows drawn from a
# few column sets, as a CSE pass's rows are) pair well, as real ones do
FOLD_PROBES = ((256, 434, 45, 4096, 0), (256, 64, 4, 4096, 0),
               (1024, 512, 20, 16384, 0), (64, 1024, 60, 16384, 0),
               (256, 434, 45, 4096, 1), (2048, 1024, 80, 16384, 1))


def _kernels():
    # the kernel module, not the same-named function its package exports
    return importlib.import_module("..kernels.blmac_fir", __package__)


def _sm_count(device) -> int:
    """The device's SMs (0 for the host, whose plain versions have none)."""
    return _kernels().sm_count(device) if device.type == "cuda" else 0


def _probe_bank(b: int, taps: int, n: int, device):
    """One K1 launch over a spread-lowpass bank, as an engine push makes
    it (its result allocated by the wrapper): (call, [walk, out bytes,
    macs])."""
    import torch

    from ..compiler import compile_bank
    from ..filters.fir import spread_lowpass_qbank

    bf = _kernels()
    prog = compile_bank(spread_lowpass_qbank(b, taps))
    sched = prog.schedule()
    terms = bf.bank_terms(sched, taps, device)
    tile = 512
    x = torch.randint(-128, 128, (1, n + taps - 1), dtype=torch.int32,
                      device=device)
    frames, n_out = bf.frame_signal_batch(x, taps, tile)
    work = bf.bank_work(sched, prog.spec.sample_bits)
    macs = sum(t * m for t, m in work) * 64 * bf.bank_k(taps) * n_out
    walk = max(m for _, m in work) * bf.bank_k(taps) // 32
    return (lambda: bf.bank_apply(frames, terms, tile, n_out),
            [float(walk), 4.0 * b * n_out, float(macs)])


def _probe_specialized(f: int, taps: int, n: int, device):
    """One K2 launch over ``f`` spread-lowpass filters: (call, [one
    thread's adds for the longest filter, all adds])."""
    import torch

    from ..compiler import compile_bank
    from ..filters.fir import spread_lowpass_qbank

    bf = _kernels()
    prog = compile_bank(spread_lowpass_qbank(f, taps))
    tile = 512
    sp = bf.SpecializedProgram(prog.pulse_schedules(), taps, tile, device)
    x = torch.randint(-128, 128, (1, n + taps - 1), dtype=torch.int32,
                      device=device)
    frames, n_out = bf.frame_signal_batch(x, taps, tile)
    n_tiles = frames.shape[1]
    walk = bf.specialized_walk(f, 1, n_tiles, tile, _sm_count(device), taps,
                               prog.pulse_counts.max())
    return (lambda: bf.specialized_call(frames, sp),
            [float(walk),
             float(f * n_tiles * tile * (taps // 2 + prog.mean_pulses))])


def _probe_fold(n_real: int, n_shared: int, per_row: int, n: int,
                clustered: int, device):
    """One combine-fold launch over a random sparse combine matrix, its
    columns drawn uniformly or (``clustered``) from 8 column sets, a
    quarter of each row's replaced: (call, [bytes, table entries ×
    outputs])."""
    import torch

    bf = _kernels()
    rng = np.random.default_rng(n_real + n_shared + per_row + clustered)
    per_row = min(per_row, n_shared)
    sets = [rng.choice(n_shared, per_row, replace=False) for _ in range(8)]
    combine = np.zeros((n_real, n_shared), np.int64)
    for r in range(n_real):
        cols = rng.choice(n_shared, per_row, replace=False)
        if clustered:
            keep = rng.random(per_row) < 0.75
            cols = np.unique(np.where(keep, sets[r % 8], cols))
        combine[r, cols] = rng.choice([-1, 1], cols.size) << rng.integers(
            0, 14, cols.size)
    table = bf.combine_table(combine, device)
    layout = table.layout(table.groups_for(1, n, _sm_count(device)))
    y = torch.randint(-(1 << 31), 1 << 31, (n_real + n_shared, 1, n),
                      dtype=torch.int32, device=device)
    return (lambda: bf.combine_fold(y, table),
            [4.0 * n * (2 * n_real + n_shared), float(layout.entries * n)])


def _fit_kernel(shapes, features, host, device) -> tuple[list[float], list]:
    """One kernel's constants from its probes' ``features`` (work
    counts), ``host`` and ``device`` µs a call: the device's time fitted
    as a launch constant plus the work's rates (`_fit`), and the host's
    median over the probes added to the constant.  Also returns a row per
    probe: its shape, host and device µs, work and fitted device µs."""
    work = [[1.0, *f] for f in features]
    coef = _fit(work, device)
    rows = [{"shape": list(p), "host_us": h, "device_us": d, "work": w[1:],
             "device_fit_us": float(np.dot(w, coef))}
            for p, h, d, w in zip(shapes, host, device, work)]
    coef[0] += np.median(host)
    return [float(c) for c in coef], rows


# batches of each probe; all the probes' batches are taken in turn, round
# after round, so that a slow spell of the shared host slows every
# kernel's batches alike and the least of each is compared fairly
CALIBRATION_ROUNDS = 5


def calibrate_backend(lane: str = CUDA_LANE, device=None, reps: int = 50,
                      report: dict | None = None) -> BackendCalibration:
    """Fit the ``"cuda"`` lane's constants on ``device`` and persist them
    in `calibration_path()` under the card's name.

    Probes (a few seconds): K1 at `BANK_PROBES`, K2 at `SPEC_PROBES`, the
    combine fold at `FOLD_PROBES`, each run in batches of ``reps`` calls
    queued behind a GPU spin (`_batch_us`), all probes in turn for
    `CALIBRATION_ROUNDS` rounds, the least batch of each kept: the
    device's time a call (CUDA events) is fitted to the kernel's formula,
    non-negative least squares,
    and the host's time a call (its clock around the enqueues, the median
    over the probes) joins the per-launch constant — the time a caller that
    waits for every dispatch pays.  ``report``, when given, receives each
    kernel's probe rows (`_fit_kernel`).  Raises when the device is not a
    CUDA device or a probe fails."""
    import torch

    if lane != CUDA_LANE:
        raise ValueError(f"only the {CUDA_LANE!r} lane is fitted, not {lane!r}")
    from ..kernels.runtime import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the {CUDA_LANE!r} lane is fitted on a CUDA "
                           f"device, not {dev}")
    kernels = (("bank", _probe_bank, BANK_PROBES),
               ("specialized", _probe_specialized, SPEC_PROBES),
               ("fold", _probe_fold, FOLD_PROBES))
    with torch.cuda.device(dev):
        probes = [(name, shape, *probe(*shape, dev))
                  for name, probe, shapes in kernels for shape in shapes]
        spins = [_spin_cycles(fn, reps) for _, _, fn, _ in probes]
        host = [float("inf")] * len(probes)
        device = list(host)
        for _ in range(CALIBRATION_ROUNDS):
            for i, ((_, _, fn, _), spin) in enumerate(zip(probes, spins)):
                h, d = _batch_us(fn, reps, spin)
                host[i], device[i] = min(host[i], h), min(device[i], d)
    fits = {}
    for name, _, _ in kernels:
        idx = [i for i, pr in enumerate(probes) if pr[0] == name]
        fits[name] = _fit_kernel([probes[i][1] for i in idx],
                                 [probes[i][3] for i in idx],
                                 [host[i] for i in idx],
                                 [device[i] for i in idx])
    if report is not None:
        report.update({name: rows for name, (_, rows) in fits.items()})
    k1, k2, kf = (fits[name][0] for name in ("bank", "specialized", "fold"))
    cal = BackendCalibration(
        lane=CUDA_LANE, spec_call_us=k2[0], spec_walk_us=k2[1],
        spec_op_us=k2[2], call_us=k1[0], walk_us=k1[1], byte_us=k1[2],
        mac_us=k1[3], step_us=0.0, unpack_us=0.0, fold_call_us=kf[0],
        fold_byte_us=kf[1], fold_op_us=kf[2], sms=_sm_count(dev),
        source="fitted", device_name=_device_name(dev),
    )
    table = _load_table()
    table.setdefault(lane, {})[cal.device_name] = asdict(cal)
    path = calibration_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{time.monotonic_ns()}.tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1)
    os.replace(tmp, path)
    return cal

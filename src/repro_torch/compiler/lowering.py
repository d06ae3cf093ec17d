"""`lower(program, backend=...)`: one compiled program, one executable per
backend — the port's counterpart of `repro.compiler.lowering`.

`lower` returns a callable ``exe(x) -> np.ndarray (B, C, n_out)`` (``x``
is ``(C, T)`` or ``(T,)`` integer samples, a numpy array or a tensor)
for:

  * ``"oracle"``      — the numpy Eq. 2 reference (`fir_bit_layers_batch`),
    reading only ``program.qbank``: the independent ground truth the other
    backends are held against, sharing no schedule machinery.  Host numpy,
    int64.
  * ``"scheduled"``   — the bank kernel K1 (`bank_schedule_apply`) over
    the memoized ``program.schedule(bank_tile, merge)``: one launch for
    every tile group, its tables built once per schedule and device.
    int32.
  * ``"specialized"`` — the pulse-specialized kernel K2 over every
    filter's pulse list (``program.pulse_schedules()``, uploaded once at
    lowering): one launch for all filters and channels.  int32.
  * ``"vmachine"``    — the vectorized §4 machine simulator programmed
    with the bank, one run per channel; the executable exposes
    ``.vmachine`` and ``.fits`` (weight-memory verdicts).  Host numpy,
    int64.
  * ``"sharded"``     — listed, not ported yet: it raises
    `NotImplementedError` (ROADMAP.md, queue 1, item 5, the sharded
    engine).

The two kernel backends run where ``device`` says (`resolve_device`:
``None`` is the GPU, and raises without one; ``"cpu"`` runs the kernels'
plain PyTorch versions); the host backends ignore it.  The reference's
``lane`` names a Pallas execution lane; the port has one route per
device, so ``lane`` takes only ``None``.

An `OptimizedProgram` (the CSE pass, `repro_torch.compiler.optimize`)
lowers through the same backends and still returns
``(out_filters, C, n_out)``: the kernel backends run the augmented
shared-row bank and fold the shared rows back in with the combine kernel
(`combine_fold`, one more launch; `combine_plain` on the CPU — the same
residue modulo 2**32 as the reference's host fold); the oracle reads
``effective_qbank()``; the vmachine widens ``coeff_bits`` by one, since
reduced and virtual rows may exceed the parent's coefficient range, and
folds exactly in int64.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.machine import MachineSpec
from ..core.vmachine import BANK_CHUNK, FirBlmacVMachine
from .program import BlmacProgram

__all__ = ["BACKENDS", "Lowered", "lower"]

BACKENDS = ("oracle", "specialized", "scheduled", "vmachine", "sharded")

# the queue item the sharded backend waits for (ROADMAP.md, queue 1)
_SHARDED = ("the 'sharded' backend is not ported yet (ROADMAP.md, queue 1, "
            "item 5: ShardedFilterBankEngine)")


class Lowered:
    """An executable lowered from a `BlmacProgram` for one backend.

    Callable ``exe(x) -> np.ndarray (B, C, n_out)``; backend-specific
    handles (``.schedule``, ``.specialized``, ``.vmachine``, ``.fits``,
    ``.device``) are attached as attributes where the backend has them.
    """

    def __init__(self, fn, backend: str, program: BlmacProgram, **extras):
        self._fn = fn
        self.backend = backend
        self.program = program
        for name, value in extras.items():
            setattr(self, name, value)

    def __call__(self, x) -> np.ndarray:
        return self._fn(x)

    def __repr__(self) -> str:
        return f"Lowered({self.backend}, {self.program!r})"


def _as_channels(x) -> np.ndarray:
    x = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
    return x[None, :] if x.ndim == 1 else x


def lower(
    program: BlmacProgram,
    backend: str = "scheduled",
    *,
    tile: int | None = None,
    bank_tile: int | None = None,
    merge: int | None = None,
    device=None,
    machine_spec: MachineSpec | None = None,
    lane: str | None = None,
) -> Lowered:
    """Lower ``program`` to an executable for ``backend`` (see module doc).

    Parameters
    ----------
    program : BlmacProgram
        The compiled artifact (`compile_bank` / `compile_packed` /
        `program_from_arrays` / `BlmacProgram.load` / `cse_pass`).
    backend : str
        One of `BACKENDS`.
    tile, bank_tile, merge
        Pin kernel geometry (None = 1024 outputs a signal tile and the
        program's memoized schedule heuristics).
    device : str | torch.device | None
        Where the kernel backends run (`resolve_device`): None is the GPU
        and raises without one; ``"cpu"`` runs the plain versions.
        Ignored by ``"oracle"`` and ``"vmachine"``.
    machine_spec : MachineSpec | None
        The vmachine's spec (default: the paper's parameters at this tap
        count).
    lane : None
        The reference's Pallas lane; the port has one route per device,
        so any lane name raises `ValueError`.

    Returns
    -------
    Lowered
        Callable ``exe(x) -> (B, C, n_out)`` numpy array.

    Raises
    ------
    TypeError
        ``program`` is not a `BlmacProgram`.
    ValueError
        Unknown ``backend``, or a ``lane`` name.
    NotImplementedError
        ``backend="sharded"``.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.compiler import compile_bank, lower
    >>> bank = np.zeros((2, 15), np.int64)
    >>> bank[:, 7] = [64, 96]
    >>> prog = compile_bank(bank)
    >>> x = np.arange(30, dtype=np.int64)
    >>> y_oracle = lower(prog, "oracle")(x)
    >>> y_k1 = lower(prog, "scheduled", device="cpu")(x)
    >>> bool((y_oracle == y_k1).all())
    True
    """
    if not isinstance(program, BlmacProgram):
        raise TypeError("lower() needs a BlmacProgram — call compile_bank")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if lane is not None:
        raise ValueError(
            f"lane {lane!r} is a Pallas lane of the reference; the port has "
            f"one route per device: pass device='cuda' (the CUDA kernels) "
            f"or device='cpu' (their plain PyTorch versions)")
    combine = program.combine  # None on plain programs
    n_real = program.out_filters if combine is not None else None

    if backend == "oracle":
        from ..filters.apply import fir_bit_layers_batch

        qbank = (
            program.qbank if combine is None else program.effective_qbank()
        )

        def run_oracle(x):
            x2 = _as_channels(x)
            # BANK_CHUNK filters a pass bounds the einsum's temporaries
            return np.concatenate([
                fir_bit_layers_batch(x2, qbank[lo:lo + BANK_CHUNK])
                for lo in range(0, max(len(qbank), 1), BANK_CHUNK)])

        return Lowered(run_oracle, backend, program)

    if backend == "vmachine":
        spec = machine_spec or MachineSpec(taps=program.taps)
        if combine is not None:
            # reduced/virtual row magnitudes can exceed the parent's
            # coefficient range — widen, as machine_cycles() does
            spec = dataclasses.replace(
                spec, coeff_bits=max(spec.coeff_bits, program.n_layers + 1)
            )
        vm = FirBlmacVMachine(spec)
        fits = vm.program_bank(program.qbank)
        # each shared row's real rows, for the fold (the combine is sparse)
        users = (None if combine is None
                 else [np.flatnonzero(col) for col in combine.T])

        def run_vmachine(x):
            x2 = _as_channels(x)
            y = np.stack(
                [vm.run(x2[c]).outputs for c in range(x2.shape[0])], axis=1
            )
            if combine is not None:
                # the vmachine is exact int64: shared rows fold without
                # wrap, landing on the parent's exact outputs — the
                # reference's y[:n_real] + combine @ y[n_real:], a shared
                # row at a time over the real rows that use it
                out = y[:n_real].copy()
                for s, rows in enumerate(users):
                    out[rows] += combine[rows, s, None, None] * y[n_real + s]
                y = out
            return y

        return Lowered(run_vmachine, backend, program, vmachine=vm, fits=fits)

    if backend == "sharded":
        raise NotImplementedError(_SHARDED)

    # the kernel backends: imported here, since the kernel modules import
    # this package
    import torch

    from ..kernels.blmac_fir import (SpecializedProgram, bank_schedule_apply,
                                     combine_fold, combine_table,
                                     frame_signal_batch, specialized_call)
    from ..kernels.runtime import as_device_tensor, resolve_device

    dev = resolve_device(device)
    tile = int(tile or 1024)
    taps = program.taps
    table = None if combine is None else combine_table(combine, dev)

    def frames_of(x):
        xi = as_device_tensor(x, dev).to(torch.int32)
        return frame_signal_batch(xi[None] if xi.ndim == 1 else xi, taps,
                                  tile)

    if backend == "scheduled":
        sched = program.schedule(bank_tile, merge)

        def run_scheduled(x):
            frames, n_out = frames_of(x)
            # one K1 launch, and one fold for an optimized program
            y = bank_schedule_apply(frames, sched, taps, tile, n_out,
                                    combine=table, n_real=n_real)
            return y.cpu().numpy()

        return Lowered(run_scheduled, backend, program, schedule=sched,
                       device=dev)

    spec_prog = SpecializedProgram(program.pulse_schedules(), taps, tile, dev)

    def run_specialized(x):
        frames, n_out = frames_of(x)
        y = specialized_call(frames, spec_prog)  # (B, C, n_tiles, tile)
        y = y.reshape(y.shape[0], y.shape[1], -1)
        if table is not None:
            y = combine_fold(y, table)
        return y[:, :, :n_out].cpu().numpy()

    return Lowered(run_specialized, backend, program, specialized=spec_prog,
                   device=dev)

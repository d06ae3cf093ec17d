"""`repro_torch.compiler.lower` against `repro.compiler.lower`.

Every backend of the port on plain and CSE-optimized programs, 1-D and
2-D signals, a one-filter bank and the adversarial bank: the same
(B, C, n_out) numbers as `repro`'s oracle and its ``"scheduled"``
backend (the fused ``xla`` lane at 8-bit samples, where it is exact;
interpreted for full-range int32 samples), tolerance 0 (int32 backends
modulo 2**32, as the reference's).  The kernel backends run here only
because ``device="cpu"`` is passed: without it and without a card they
raise.  ``"sharded"`` waits for queue 1, item 5; an unknown backend, a
non-program and a reference lane name are refused.
"""
import importlib

import numpy as np
import pytest
import torch

import repro.compiler as rc
import repro.core as rcore
import repro_torch.compiler as tc
from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro_torch.core import MachineSpec

tk = importlib.import_module("repro_torch.kernels.blmac_fir")

BANKS = {
    "random": lambda: random_type1_bank(9, 31, seed=11),
    "sweep127": lambda: sampled_sweep_bank(127, n_div=10, n_filters=10,
                                           seed=2),
    "adversarial": lambda: adversarial_bank(31, seed=4),
    "one_filter": lambda: sampled_sweep_bank(63, n_div=10, n_filters=1,
                                             seed=5),
}
KERNEL_BACKENDS = ("scheduled", "specialized")
PORT_BACKENDS = ("oracle", "scheduled", "specialized", "vmachine")
SAMPLES = {"8bit": (-128, 128), "int32": (-(1 << 31), 1 << 31)}


def _signal(taps, shape, samples, seed=0):
    lo, hi = SAMPLES[samples]
    n = taps - 1 + 70
    return np.random.default_rng(seed).integers(lo, hi, shape + (n,))


def _programs(bank, optimized):
    q = BANKS[bank]()
    port, ref = tc.compile_bank(q), rc.compile_bank(q)
    if optimized:
        port, ref = tc.cse_pass(port), rc.cse_pass(ref)
    assert port.key == ref.key
    return port, ref


@pytest.mark.parametrize("optimized", [False, True], ids=["plain", "cse"])
@pytest.mark.parametrize("bank", sorted(BANKS))
def test_every_backend_matches_the_reference(bank, optimized):
    port, ref = _programs(bank, optimized)
    x = _signal(port.taps, (2,), "8bit", seed=len(bank))
    want = rc.lower(ref, "oracle")(x)
    assert want.shape == (port.out_filters, 2, 70)
    ref_k1 = np.asarray(rc.lower(ref, "scheduled", tile=128, lane="xla",
                                 interpret=True)(x))
    assert np.array_equal(ref_k1, want)
    for backend in PORT_BACKENDS:
        exe = tc.lower(port, backend, tile=128, device="cpu")
        assert exe.backend == backend and exe.program is port
        y = exe(x)
        assert isinstance(y, np.ndarray), backend
        assert y.dtype == (np.int64 if backend in ("oracle", "vmachine")
                           else np.int32), backend
        assert y.shape == want.shape, backend
        assert np.array_equal(y, want), backend
    vm = tc.lower(port, "vmachine")
    rvm = rc.lower(ref, "vmachine")
    assert np.array_equal(vm.fits, rvm.fits)
    assert vm.vmachine.spec.coeff_bits == rvm.vmachine.spec.coeff_bits


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("optimized", [False, True], ids=["plain", "cse"])
def test_one_dimensional_signal_is_one_channel(backend, optimized):
    port, ref = _programs("random", optimized)
    x = _signal(port.taps, (), "8bit", seed=3)
    y = tc.lower(port, backend, device="cpu")(x)
    assert y.shape == (port.out_filters, 1, 70)
    assert np.array_equal(y, rc.lower(ref, "oracle")(x))
    # a tensor signal works as well as an array
    assert np.array_equal(tc.lower(port, backend, device="cpu")(
        torch.as_tensor(x)), y)


@pytest.mark.parametrize("optimized", [False, True], ids=["plain", "cse"])
@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_kernel_backends_wrap_like_the_reference(backend, optimized):
    """Full-range int32 samples: every int32 backend is the oracle modulo
    2**32, as the reference's interpreted kernel."""
    port, ref = _programs("adversarial", optimized)
    x = _signal(port.taps, (2,), "int32", seed=9)
    want = rc.lower(ref, "oracle")(x).astype(np.int32)
    y = tc.lower(port, backend, tile=128, device="cpu")(x)
    assert np.array_equal(y, want)
    ref_y = np.asarray(rc.lower(ref, "scheduled", tile=128,
                                interpret=True)(x))
    assert np.array_equal(y, ref_y)


def test_kernel_backends_take_one_launch_on_the_cpu_lane():
    """On the CPU the kernels' plain versions run and no launch is
    counted; the lowered executables keep their schedule and tables."""
    port, _ = _programs("sweep127", True)
    x = _signal(port.taps, (1,), "8bit")
    tk.reset_launch_counts()
    sched = tc.lower(port, "scheduled", device="cpu")
    spec = tc.lower(port, "specialized", device="cpu")
    sched(x), spec(x)
    assert (tk.bank_apply.launches, tk.specialized_call.launches,
            tk.combine_fold.launches) == (0, 0, 0)
    assert sched.schedule is port.schedule()
    assert sched.device.type == spec.device.type == "cpu"
    assert spec.specialized.n_filters == port.n_filters
    assert "scheduled" in repr(sched)


def test_geometry_and_machine_spec_are_passed_through():
    port, ref = _programs("sweep127", False)
    x = _signal(port.taps, (1,), "8bit", seed=4)
    want = rc.lower(ref, "oracle")(x)
    for kw in ({"bank_tile": 4, "merge": 1}, {"bank_tile": 8, "merge": 8},
               {"tile": 64}):
        exe = tc.lower(port, "scheduled", device="cpu", **kw)
        assert np.array_equal(exe(x), want)
        if "bank_tile" in kw:
            assert exe.schedule.tile_size == kw["bank_tile"]
            assert exe.schedule.merge == kw["merge"]
    spec = MachineSpec(taps=127, weight_mem_codes=200, fused_last_add=True)
    vm = tc.lower(port, "vmachine", machine_spec=spec)
    rvm = rc.lower(ref, "vmachine", machine_spec=rcore.MachineSpec(
        taps=127, weight_mem_codes=200, fused_last_add=True))
    assert vm.vmachine.spec is spec
    assert np.array_equal(vm.fits, rvm.fits)
    assert np.array_equal(vm(x), want)


def test_refusals():
    port, _ = _programs("random", False)
    with pytest.raises(TypeError, match="BlmacProgram"):
        tc.lower(port.qbank, "oracle")
    with pytest.raises(ValueError, match="unknown backend"):
        tc.lower(port, "pallas")
    with pytest.raises(NotImplementedError, match="item 5"):
        tc.lower(port, "sharded", device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        tc.lower(tc.cse_pass(port), "sharded")
    assert "sharded" in tc.BACKENDS
    assert set(tc.BACKENDS) == set(rc.BACKENDS)


@pytest.mark.parametrize("lane", ["interpret", "mosaic", "triton", "xla"])
def test_a_reference_lane_is_refused_naming_the_devices(lane):
    port, _ = _programs("random", False)
    with pytest.raises(ValueError, match="device='cuda'.*device='cpu'"):
        tc.lower(port, "scheduled", lane=lane, device="cpu")


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_kernel_backends_default_to_the_gpu(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = _programs("random", False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.lower(port, backend, device=device)
    # the host backends ignore the device
    x = _signal(port.taps, (1,), "8bit")
    for host in ("oracle", "vmachine"):
        assert tc.lower(port, host, device="cuda")(x).shape == \
            (port.n_filters, 1, 70)


def test_docstring_example_runs():
    import doctest

    import repro_torch.compiler.lowering as lowering

    res = doctest.testmod(lowering, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0

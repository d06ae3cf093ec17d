"""The port's differential harness (`tests/torch_differential.py`) on the
reference's bank generators: `port_five_way_check` and `port_cse_check`
on random, sampled-sweep and adversarial banks, each leg held against
`repro` on the same program arrays, tolerance 0.  The kernel legs run
their plain versions because ``device="cpu"`` is passed."""
import numpy as np
import pytest

from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro_torch.compiler import compile_bank
from repro_torch.core import MachineSpec
from torch_differential import port_cse_check, port_five_way_check

BANKS = {
    "random15": lambda: random_type1_bank(6, 15, seed=15, density=0.7),
    "random31": lambda: random_type1_bank(5, 31, seed=31, density=0.6),
    "random63_dense": lambda: random_type1_bank(4, 63, seed=63),
    "random127_overflows": lambda: random_type1_bank(4, 127, seed=9),
    "sweep127": lambda: sampled_sweep_bank(127, n_div=10, n_filters=8,
                                           seed=1),
    "sweep55": lambda: sampled_sweep_bank(55, n_div=10, n_filters=8,
                                          seed=2),
    "adversarial31": lambda: adversarial_bank(31),
    "adversarial15": lambda: adversarial_bank(15, seed=3),
}


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_port_five_way(bank):
    q = BANKS[bank]()
    rep = port_five_way_check(q, device="cpu", seed=len(bank))
    assert rep.n_filters == q.shape[0] and rep.n_out == 48
    assert rep.reference_legs == 5
    assert rep.scalar_checked + rep.scalar_rejected > 0
    assert rep.scalar_rejected == int((~rep.fits).sum())
    if bank == "random127_overflows":  # ~370 codes: nothing fits
        assert not rep.fits.any()


@pytest.mark.parametrize("spec_kw", [{"fused_last_add": True},
                                     {"start_overhead": 2},
                                     {"weight_mem_codes": 120}])
def test_port_five_way_spec_variants(spec_kw):
    q = sampled_sweep_bank(127, n_div=10, n_filters=6, seed=4)
    rep = port_five_way_check(q, spec=MachineSpec(taps=127, **spec_kw),
                              device="cpu", scalar_samples=3)
    assert rep.reference_legs == 5


def test_port_five_way_wide_samples_and_a_shared_program():
    """Full-range int32 samples (the reference's interpreted leg, its
    xla lane being exact only at 8 bits) on a prebuilt program, with a
    spec wide enough to hold them."""
    q = adversarial_bank(31, seed=6)
    prog = compile_bank(q)
    spec = MachineSpec(taps=31, sample_bits=32)
    x = np.random.default_rng(7).integers(-(1 << 31), 1 << 31, 30 + 40)
    with pytest.raises(AssertionError, match="scheduled"):
        # the int32 legs wrap modulo 2**32 where the int64 oracle does not
        port_five_way_check(program=prog, x=x, spec=spec, device="cpu")
    small = np.random.default_rng(7).integers(-(1 << 12), 1 << 12, 70)
    rep = port_five_way_check(q, x=small, program=prog,
                              spec=MachineSpec(taps=31, sample_bits=13),
                              device="cpu")
    assert rep.n_out == 40


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_port_cse(bank):
    q = BANKS[bank]()
    rep = port_cse_check(q, device="cpu", seed=len(bank))
    assert rep["adds_optimized"] <= rep["adds_parent"]
    if rep["n_shared"]:
        assert rep["reference_legs"] == 4
        assert rep["scalar_checked"] + rep["scalar_rejected"] > 0


@pytest.mark.parametrize("max_shared", [1, 4])
def test_port_cse_capped(max_shared):
    q = sampled_sweep_bank(127, n_div=10, n_filters=8, seed=5)
    rep = port_cse_check(q, device="cpu", max_shared=max_shared)
    assert 0 < rep["n_shared"] <= max_shared


def test_harness_needs_a_bank():
    for check in (port_five_way_check, port_cse_check):
        with pytest.raises(ValueError, match="qbank or program"):
            check(device="cpu")

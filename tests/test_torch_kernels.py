"""The port's kernel layer against the reference's, on the CPU.

On the CPU every port wrapper runs its kernel's plain PyTorch version;
the reference runs its Pallas kernels in interpret mode or through its
compiled XLA lane, as its own tests do.  Inputs are numpy draws from
fixed seeds; every comparison is exact (tolerance 0: integer paths).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential import adversarial_bank, random_type1_bank, sampled_sweep_bank
from repro.compiler import compile_bank as ref_compile
from repro.filters import fir_bit_layers_batch as ref_oracle
from repro.kernels import blmac_fir as ref_blmac_fir
from repro.kernels import blmac_fir_bank as ref_blmac_fir_bank
from repro.kernels.ref import blmac_fir_ref as ref_blmac_fir_ref
from repro.kernels.ref import fir_direct_ref as ref_fir_direct_ref
from repro_torch.compiler import cache_stats, clear_caches, compile_bank
from repro_torch.core import po2_quantize_batch
from repro_torch.filters import fir_bit_layers_batch, sweep_bank, sweep_specs
from repro_torch.kernels import blmac_fir, blmac_fir_bank
from repro_torch.kernels.ref import blmac_fir_ref, fir_direct_ref

# the kernel modules, not the same-named functions their packages export
rk = importlib.import_module("repro.kernels.blmac_fir")
tk = importlib.import_module("repro_torch.kernels.blmac_fir")
CPU = "cpu"


def _x(shape, seed, lim=128):
    return np.random.default_rng(seed).integers(-lim, lim, shape)


@pytest.mark.parametrize("taps,tile,t", [(1, 128, 50), (7, 128, 300),
                                         (31, 256, 1000), (127, 512, 4000),
                                         (63, 1024, 64)])
def test_frame_signal_batch_matches(taps, tile, t):
    x = _x((3, t), taps).astype(np.int32)
    pf, pn = tk.frame_signal_batch(torch.as_tensor(x), taps, tile)
    rf, rn = rk.frame_signal_batch(jnp.asarray(x), taps, tile)
    assert pn == rn and tuple(pf.shape) == rf.shape
    assert np.array_equal(pf.numpy(), np.asarray(rf))
    pf1, _ = tk.frame_signal(torch.as_tensor(x[0]), taps, tile)
    assert np.array_equal(pf1.numpy(), np.asarray(rk.frame_signal(
        jnp.asarray(x[0]), taps, tile)[0]))


def _group_case(bank, merge, bank_tile, tile, channels=2, t=700, lim=128):
    q = {"random": lambda: random_type1_bank(20, 31, seed=1),
         "adversarial": lambda: adversarial_bank(31, seed=2),
         "sweep": lambda: sampled_sweep_bank(63, n_div=10, n_filters=12)}[bank]()
    prog = compile_bank(q)
    sched = prog.schedule(bank_tile, merge)
    x = _x((channels, t), merge, lim).astype(np.int32)
    frames, n_out = tk.frame_signal_batch(torch.as_tensor(x), prog.taps, tile)
    return q, prog, sched, x, frames, n_out


@pytest.mark.parametrize("bank,merge,bank_tile", [
    ("random", 8, None),       # one group
    ("adversarial", 1, 1),     # several groups, all-zero groups among them
    ("sweep", 4, 8),
    ("sweep", 32, None),
])
def test_bank_plain_matches_reference_xla_lane(bank, merge, bank_tile):
    q, prog, sched, x, frames, _ = _group_case(bank, merge, bank_tile, 256)
    rframes = jnp.asarray(frames.numpy())
    for g in sched.groups:
        if not g.sel_layers:
            continue
        op = g.packed.view(np.int32)
        got = tk.bank_call_plain(frames, torch.tensor(op), prog.taps,
                                 g.schedule, g.tail_shift, 256)
        want = rk._bank_call_xla(rframes, jnp.asarray(op), prog.taps,
                                 g.schedule, g.tail_shift, 256)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_bank_plain_matches_reference_interpret_kernel():
    q, prog, sched, x, frames, _ = _group_case("adversarial", 8, 2, 128,
                                               channels=1, t=300)
    rframes = jnp.asarray(frames.numpy())
    groups = [g for g in sched.groups if g.sel_layers]
    assert len(groups) >= 2
    for g in groups:
        op = g.packed.view(np.int32)
        got = tk.bank_call_plain(frames, torch.tensor(op), prog.taps,
                                 g.schedule, g.tail_shift, 128)
        want = rk._bank_call(rframes, jnp.asarray(op), prog.taps, g.schedule,
                             g.tail_shift, 128, sched.tile_size, True)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_bank_schedule_apply_with_all_zero_groups():
    q, prog, sched, x, frames, n_out = _group_case("adversarial", 1, 1, 256)
    assert any(not g.sel_layers for g in sched.groups)
    got = tk.bank_schedule_apply(frames, sched, prog.taps, 256)
    want = rk.bank_schedule_apply(jnp.asarray(frames.numpy()),
                                  ref_compile(q).schedule(1, 1), prog.taps,
                                  256, False, lane="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[:, :, :n_out], ref_oracle(x, q))


@pytest.mark.parametrize("case", ["1d", "multichannel", "taps1", "one_filter"])
def test_blmac_fir_bank_matches_reference(case):
    if case == "taps1":
        q = np.array([[3], [-7], [0]], np.int64)
    elif case == "one_filter":
        q = sampled_sweep_bank(31, n_div=10, n_filters=1, seed=3)
    else:
        q = sampled_sweep_bank(63, n_div=10, n_filters=10, seed=4)
    x = _x(600 if case == "1d" else (3, 600), 5)
    got = blmac_fir_bank(x, q, tile=256, device=CPU)
    assert got.dtype == torch.int32
    oracle = fir_bit_layers_batch(x, q)
    assert np.array_equal(oracle, ref_oracle(x, q))
    if case == "1d":
        oracle = oracle[:, 0, :]
    assert np.array_equal(got.numpy(), oracle)
    if case == "one_filter":  # the reference's B <= 1 fast path, interpreted
        want = ref_blmac_fir_bank(jnp.asarray(x), q, tile=256, interpret=True)
    else:
        want = rk.blmac_fir_bank(jnp.asarray(x), ref_compile(q).packed,
                                 q.shape[1], 256, fast_path=False, lane="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_specialized_plain_matches_reference_interpret():
    q = sampled_sweep_bank(63, n_div=10, n_filters=3, seed=6)
    prog = compile_bank(q)
    x = _x(900, 7)
    for pulses in prog.pulse_schedules():
        got = tk.blmac_fir_specialized(torch.as_tensor(x), pulses, 63, 256)
        want = rk.blmac_fir_specialized(jnp.asarray(x), pulses, 63, 256,
                                        interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(want))
    info = tk.specialized_program.cache_info()
    tk.blmac_fir_specialized(torch.as_tensor(x), prog.pulse_schedules()[0],
                             63, 256)
    assert tk.specialized_program.cache_info().hits == info.hits + 1


def test_pulse_tuples_match_reference():
    q = adversarial_bank(31, seed=8)
    prog = compile_bank(q)
    for b in range(len(q)):
        assert tk.pulses_msb_first(q[b]) == rk.pulses_msb_first(q[b])
        assert tk.pulses_from_packed(prog.packed[b], 31) == \
            rk.pulses_from_packed(prog.packed[b], 31)


@pytest.mark.parametrize("specialize", [True, False])
def test_blmac_fir_matches_reference(specialize):
    q = sampled_sweep_bank(55, n_div=10, n_filters=1, seed=9)[0]
    x = _x(1500, 10).astype(np.int16)
    got = blmac_fir(x, q, specialize=specialize, tile=512, device=CPU)
    want = ref_blmac_fir(jnp.asarray(x), q, specialize=specialize, tile=512,
                         interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_blmac_fir_dynamic_matches_reference():
    from repro_torch.core import csd_digits

    q = sampled_sweep_bank(31, n_div=10, n_filters=1, seed=11)[0]
    x = _x(500, 12)
    trits = csd_digits(q[:16], n_digits=17).T
    got = tk.blmac_fir_dynamic(torch.as_tensor(x), trits, 31, 17, tile=256)
    want = rk.blmac_fir_dynamic(jnp.asarray(x), trits, 31, 17, tile=256,
                                interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wide_samples_wrap_modulo_2_32():
    """±2**20 samples overflow int32: the port must wrap exactly as the
    reference's int32 contraction does (merge 32 keeps the reference's XLA
    lane off its float32 route, which assumes 8-bit samples)."""
    q = random_type1_bank(16, 31, seed=12)
    x = _x((2, 800), 13, lim=1 << 20)
    got = blmac_fir_bank(x, q, tile=256, merge=32, device=CPU)
    prog = ref_compile(q)
    want = rk.blmac_fir_bank(jnp.asarray(x), prog.packed, 31, 256,
                             fast_path=False, schedule=prog.schedule(None, 32),
                             lane="xla")
    oracle = ref_oracle(x, q)
    assert np.abs(oracle).max() >= 1 << 31  # the case really wraps
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), oracle.astype(np.int32))


def test_refs_match_reference():
    q = sampled_sweep_bank(63, n_div=10, n_filters=1, seed=14)[0]
    x = _x(700, 15).astype(np.int32)
    want = np.asarray(ref_fir_direct_ref(jnp.asarray(x), q))
    assert np.array_equal(fir_direct_ref(torch.as_tensor(x), q).numpy(), want)
    assert np.array_equal(blmac_fir_ref(torch.as_tensor(x), q).numpy(), want)
    assert np.array_equal(
        np.asarray(ref_blmac_fir_ref(jnp.asarray(x), q)), want)


def test_wrappers_count_launches_only_on_the_card():
    tk.reset_launch_counts()
    blmac_fir_bank(_x((1, 300), 16), random_type1_bank(4, 15, seed=16),
                   device=CPU)
    assert tk.bank_apply.launches == 0 and tk.specialized_call.launches == 0


def test_rejects_bad_operands():
    q, prog, sched, x, frames, _ = _group_case("random", 8, None, 256)
    g = sched.groups[0]
    terms = tk.group_terms(g.packed, g.schedule, g.tail_shift, prog.taps)
    n_out = frames.shape[1] * 256
    with pytest.raises(ValueError):  # int64 frames
        tk.bank_apply(frames.to(torch.int64), terms, 256, n_out)
    with pytest.raises(ValueError):  # wrong output buffer
        tk.bank_apply(frames, terms, 256, n_out,
                      out=torch.empty(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        blmac_fir(np.zeros(50), np.arange(31), device=CPU)


def _fir127():
    """Row 4,950 of the 127-tap sweep at N = 100 (a bandpass, 263 pulses):
    the benchmark's one-filter configuration."""
    spec = sweep_specs(100)[4950]
    return po2_quantize_batch(sweep_bank(127, 100, specs=[spec]), 16)[0][0]


@pytest.mark.parametrize("taps,bank,samples,n_out", [
    (55, "random", "8bit", 2 * 8192 + 37),
    (55, "random", "int32", 1000),
    (127, "fir127", "8bit", 8192 + 101),
    (127, "fir127", "int32", 3 * 1024 + 7),
    (127, "random", "8bit", 700),
    (127, "random", "int32", 8192 + 64 + 1),
    (255, "random", "8bit", 4099),
    (255, "random", "int32", 8192 - 1),
    (127, "random", "x256", 2 * 8192 + 3),
])
def test_specialized_toeplitz_walk_matches_plain_and_oracle(taps, bank,
                                                            samples, n_out):
    """The tensor-core K2's arithmetic (`specialized_toeplitz_walk`: s8
    sample planes, windows of 64 outputs, each term a Hankel-by-Toeplitz
    product in a Horner chain modulo 2**32) read from the very tables a
    `SpecializedProgram` builds, against the plain version and the int64
    oracle: the fir127 filter alone and three random 16-bit symmetric
    filters, 8-bit and full-range int32 samples (outputs wrapping across
    2**31) and 8-bit samples times 256 (plane 0 dead below a live plane 1),
    output counts off multiples of 64 and 8,192."""
    q = _fir127()[None] if bank == "fir127" else random_type1_bank(
        3, taps, seed=taps)
    scheds = compile_bank(q).pulse_schedules()
    lim = 1 << 31 if samples == "int32" else 1 << 7
    x = _x((2, n_out + taps - 1), taps + n_out, lim).astype(np.int32)
    if samples == "x256":
        x *= 256
    tile = 1024
    frames, got_n = tk.frame_signal_batch(torch.as_tensor(x), taps, tile)
    assert got_n == n_out
    prog = tk.SpecializedProgram(scheds, taps, tile, torch.device(CPU))
    image, index, terms, b_bytes = prog.toeplitz
    walk = tk.specialized_toeplitz_walk(frames.numpy(), image, index, terms,
                                        taps, tile)
    plain = torch.stack([tk.specialized_plain(frames, p, taps, tile)
                         for p in scheds]).numpy()
    assert np.array_equal(walk, plain)
    oracle = fir_bit_layers_batch(x.astype(np.int64), q)
    if samples == "int32":
        assert np.abs(oracle).max() >= 1 << 31  # the outputs really wrap
    assert np.array_equal(walk.reshape(len(q), 2, -1)[:, :, :n_out],
                          oracle.astype(np.int32))
    assert b_bytes == max(16 * index[:, 1].max(), tk.TOEPLITZ_CHUNK)
    if bank == "fir127":  # 3 runs of span <= 7, one plane for 8-bit samples
        assert len(scheds[0]) == 263
        assert b_bytes == 5 * tk.TOEPLITZ_CHUNK
        assert index[0, 3:].tolist() == [3, 6, 9, 11, 0]
        assert terms[:3, 1].tolist() == [0, 0, 0]


def test_specialized_route_by_shape_and_tables_built_once():
    """The tensor-core design where a launch fills the card (the fir127
    cell's 1 × 64 × 1,024 tiles; `blmac_fir`'s 1 × 2**20), the CUDA-core
    walk on a short push and past 255 taps; the program's tables are
    built once, and a second call of the same program builds nothing."""
    sms = 132
    assert tk.specialized_route(1, 64, 1024, 1024, sms, 127) == "wgmma"
    assert tk.specialized_route(1, 1, 1024, 1024, sms, 127) == "wgmma"
    assert tk.specialized_route(1, 2, 2, 1024, sms, 127) == "walk"
    assert tk.specialized_route(1, 64, 1024, 1024, sms, 257) == "walk"
    assert tk.specialized_route(1, 64, 1024, 1024, sms, 255) == "wgmma"
    clear_caches()
    q = _fir127()[None]
    x = _x((2, 3000), 5)

    def builds():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            y = blmac_fir_bank(x, q, device=CPU)
        return y, [e.name for e in prof.events()
                   if e.name.startswith("repro_torch.build.")]

    y1, cold = builds()
    y2, warm = builds()
    assert "repro_torch.build.specialized" in cold and warm == []
    assert torch.equal(y1, y2)
    assert cache_stats()["specialized"]["misses"] == 1
    assert cache_stats()["specialized"]["hits"] == 1
    pulses = tk.pulses_msb_first(q[0])
    prog = tk.specialized_program(pulses, 127, 1024, CPU)
    assert prog.toeplitz is not None and prog.toeplitz_tensors is None
    assert tk.specialized_program(pulses, 127, 1024, CPU).toeplitz \
        is prog.toeplitz

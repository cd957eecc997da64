"""Bank correlator tests on the CPU: the plain XLA bank (``xla_bank``) and
the Pallas Triton kernel (``triton_bank``, interpret mode) against the
float64 oracle and the golden values.

Mirrors the reference's per-algorithm golden testsets
(`/root/reference/test/algorithms.jl`) over the bank algorithms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuacceleratedtracking_tpu.bench import oracle
from gpuacceleratedtracking_tpu.models import (
    GPSL1,
    GPSL5,
    EPLCorrelator,
    correlator_sample_shifts,
    gen_signal,
    soa,
)
from gpuacceleratedtracking_tpu.ops import registry
from gpuacceleratedtracking_tpu.ops.triton_bank import correlate_triton_bank

GOLDEN = np.array([1476.0, 2500.0, 1476.0])
BANKS = ["xla_bank", "triton_bank"]


def bank_fn(algo):
    if algo == "triton_bank":
        return functools.partial(correlate_triton_bank, interpret=True)
    return registry.get(algo)


def run_bank(algo, system, sre, sim, fs, shifts, prns, fcar, *, phicar=0.0,
             fcode=None, phicode=0.0):
    """Bank accumulators as complex ``[K, (A,) L]``; scalars broadcast."""
    k = len(prns)
    full = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), (k,))
    fn = jax.jit(functools.partial(
        bank_fn(algo), sample_shifts=tuple(int(s) for s in shifts),
        code_length=system.code_length, sampling_frequency=fs))
    are, aim = fn(
        sre, sim, jnp.asarray(system.codes), jnp.asarray(prns, jnp.int32),
        full(fcar), carrier_phase=full(phicar),
        code_frequency=full(system.code_frequency if fcode is None else fcode),
        code_phase=full(phicode),
    )
    return np.asarray(are) + 1j * np.asarray(aim)


def run(algo, system, signal, fs, shifts, *, prn=0, fcar=1500.0, phicar=0.0,
        phicode=0.0):
    """One channel through a bank algorithm: complex ``[(A,) L]``."""
    sre, sim = soa(signal)
    return run_bank(algo, system, sre, sim, fs, shifts, [prn], fcar,
                    phicar=phicar, phicode=phicode)[0]


def f64(system, signal, fs, shifts, *, prn=0, fcar=1500.0, phicar=0.0,
        fcode=None, phicode=0.0):
    return oracle.correlate(
        signal, system.codes, prn, fcar, fs, phicar,
        system.code_frequency if fcode is None else fcode, phicode, shifts)


@pytest.mark.parametrize("algo", BANKS)
class TestPallasKernels:
    """Single-channel scenarios through each bank algorithm."""

    def test_golden(self, algo):
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 2500)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        acc = run(algo, system, signal, fs, shifts)
        np.testing.assert_allclose(acc.real, GOLDEN, rtol=3.5e-4)
        np.testing.assert_allclose(acc.imag, 0.0, atol=0.5)

    def test_matches_oracle_offsets(self, algo):
        system = GPSL1()
        N = 4096
        kwargs = dict(prn=5, fcar=-2345.0, phicar=0.9, phicode=517.3)
        signal, fs = gen_signal(
            system, kwargs["prn"], kwargs["fcar"], N,
            start_code_phase=kwargs["phicode"],
            start_carrier_phase=kwargs["phicar"],
        )
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        got = run(algo, system, signal, fs, shifts, **kwargs)
        want = f64(system, signal, fs, shifts, **kwargs)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.2)

    def test_multi_antenna(self, algo):
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 2500, num_ants=4)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        acc = run(algo, system, signal, fs, shifts)
        assert acc.shape == (4, 3)
        for a in range(4):
            np.testing.assert_allclose(acc[a].real, GOLDEN, rtol=3.5e-4)

    def test_seven_taps(self, algo):
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 8192)
        shifts = correlator_sample_shifts(system, EPLCorrelator(7), fs)
        got = run(algo, system, signal, fs, shifts)
        want = f64(system, signal, fs, shifts)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.3)

    def test_l5(self, algo):
        system = GPSL5()
        signal, fs = gen_signal(system, 3, 2000.0, 32768)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        got = run(algo, system, signal, fs, shifts, prn=3, fcar=2000.0)
        want = f64(system, signal, fs, shifts, prn=3, fcar=2000.0)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=3.0)

    def test_wide_span(self, algo):
        # Tap span >= 128 samples at an interpret-affordable N — the reference
        # envelope's fs >= 131 MHz regime, where its mega-kernel keeps
        # working (`/root/reference/src/algorithms.jl:720-825`).
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 4096)
        shifts = np.array([-150, 0, 163])
        got = run(algo, system, signal, fs, shifts)
        want = f64(system, signal, fs, shifts)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.3)

    def test_tile_unaligned_n(self, algo):
        # N not a multiple of the 128-sample row or the kernel's tile. (A
        # 0.3-chip start phase keeps the late tap's halo sample, 1023 chips
        # in at zero phase, off an exact chip boundary, where float64's own
        # rounding decides the oracle's chip.)
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 500.0, 1000, start_code_phase=0.3)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        got = run(algo, system, signal, fs, shifts, fcar=500.0, phicode=0.3)
        want = f64(system, signal, fs, shifts, fcar=500.0, phicode=0.3)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.2)


def _random_case(system, N, K, seed=0, num_ants=None):
    rng = np.random.default_rng(seed)
    fs = N / 1e-3
    signal, _ = gen_signal(system, 0, 1500.0, N, num_ants=num_ants)
    return dict(
        signal=signal, fs=fs,
        shifts=correlator_sample_shifts(system, EPLCorrelator(3), fs),
        prns=np.arange(K) % 32,
        fcar=(1500.0 + rng.uniform(-4000.0, 4000.0, K)).astype(np.float32),
        phicar=rng.uniform(0, 2 * np.pi, K).astype(np.float32),
        fcode=(system.code_frequency + rng.uniform(-3, 3, K)).astype(np.float32),
        phicode=rng.uniform(0, system.code_length, K).astype(np.float32),
    )


def _check_bank_vs_f64(algo, system, case, atol_over_n=1e-4):
    sre, sim = soa(case["signal"])
    got = run_bank(algo, system, sre, sim, case["fs"], case["shifts"],
                   case["prns"], case["fcar"], phicar=case["phicar"],
                   fcode=case["fcode"], phicode=case["phicode"])
    n = case["signal"].shape[-1]
    for k in range(len(case["prns"])):
        want = f64(system, case["signal"], case["fs"], case["shifts"],
                   prn=int(case["prns"][k]), fcar=float(case["fcar"][k]),
                   phicar=float(case["phicar"][k]),
                   fcode=float(case["fcode"][k]),
                   phicode=float(case["phicode"][k]))
        np.testing.assert_allclose(got[k], want, rtol=0, atol=atol_over_n * n,
                                   err_msg=f"channel {k}")
    return got


@pytest.mark.parametrize("algo", BANKS)
class TestBankKernel:
    """Multi-channel bank scenarios, each against the float64 oracle."""

    def test_matches_per_channel_oracle(self, algo):
        system = GPSL1()
        N = 4096
        fs = N / 1e-3
        prns = np.arange(4)
        dops = np.linspace(-3000.0, 3000.0, 4)
        sigs = [gen_signal(system, int(p), float(d), N)[0]
                for p, d in zip(prns, dops)]
        mixed = sum(sigs[1:], sigs[0])
        sre, sim = soa(mixed)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        got = run_bank(algo, system, sre, sim, fs, shifts, prns,
                       1500.0 + dops)
        assert got.shape == (4, 3)
        for k in range(4):
            want = f64(system, mixed, fs, shifts, prn=int(prns[k]),
                       fcar=1500.0 + float(dops[k]))
            np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=0.5)

    def test_multi_antenna_bank(self, algo):
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 2500, num_ants=2)
        sre, sim = soa(signal)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        acc = run_bank(algo, system, sre, sim, fs, shifts, [0, 0], 1500.0)
        assert acc.shape == (2, 2, 3)
        for k in range(2):
            for a in range(2):
                np.testing.assert_allclose(acc[k, a].real, GOLDEN, rtol=3.5e-4)

    def test_l5_bank(self, algo):
        system = GPSL5()
        N = 32768
        fs = N / 1e-3
        signal, _ = gen_signal(system, 3, 2000.0, N)
        sre, sim = soa(signal)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        got = run_bank(algo, system, sre, sim, fs, shifts, [3, 3], 2000.0)
        want = f64(system, signal, fs, shifts, prn=3, fcar=2000.0)
        for k in range(2):
            np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=3.0)

    def test_l5_m4_l7_challenge_config(self, algo):
        # The reference's "unsolved challenge": GPS L5, 4 antennas, 7 taps
        # was not real-time on either of its GPUs (`paper/paper.tex:345`).
        system = GPSL5()
        N = 32768
        fs = N / 1e-3
        signal, _ = gen_signal(system, 6, -1800.0, N, num_ants=4)
        sre, sim = soa(signal)
        shifts = correlator_sample_shifts(system, EPLCorrelator(7), fs)
        got = run_bank(algo, system, sre, sim, fs, shifts, [6], -1800.0)
        assert got.shape == (1, 4, 7)
        want = f64(system, signal, fs, shifts, prn=6, fcar=-1800.0)
        np.testing.assert_allclose(got[0], want, rtol=2e-3, atol=1e-4 * N)

    def test_onehot_wide_span(self, algo):
        # Any tap span works: every tap is its own gather, no replica halo.
        system = GPSL1()
        N, K = 4096, 2
        fs = N / 1e-3
        signal, _ = gen_signal(system, 0, 1500.0, N)
        sre, sim = soa(signal)
        shifts = (-160, 0, 170)
        got = run_bank(algo, system, sre, sim, fs, shifts, [0] * K, 1500.0)
        want = f64(system, signal, fs, shifts)
        for k in range(K):
            np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=0.3)

    def test_wide_span_parity(self, algo):
        system = GPSL1()
        case = _random_case(system, 8192, 4, seed=5)
        case["shifts"] = np.array([-160, 0, 170])
        _check_bank_vs_f64(algo, system, case)

    def test_reference_envelope_wide_cell(self, algo):
        # GPS L1 at fs = 131.072 MHz (N = 2^17): unit tap shift = 64
        # samples, L=3 span = 128 (`/root/reference/scripts/
        # run_benchmarks_gpsl1.jl:8`).
        system = GPSL1()
        case = _random_case(system, 131072, 2, seed=9)
        assert int(case["shifts"].max() - case["shifts"].min()) >= 128
        _check_bank_vs_f64(algo, system, case)

    def test_l5_wideband(self, algo):
        # 65.536 MHz GPS L5 (10.23 MHz code): 10230 chips per block, where
        # a plain f32 code phase would misplace chip boundaries.
        system = GPSL5()
        _check_bank_vs_f64(algo, system, _random_case(system, 65536, 3, seed=2))

    def test_golden_prompt(self, algo):
        system = GPSL1()
        N = 32768
        fs = N / 1e-3
        signal, _ = gen_signal(system, 0, 1500.0, N)
        sre, sim = soa(signal)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        acc = run_bank(algo, system, sre, sim, fs, shifts, [0, 0, 0], 1500.0)
        np.testing.assert_allclose(acc[:, 1].real, np.full(3, float(N)),
                                   rtol=1e-6)

    def test_multi_tile_and_padded_k(self, algo):
        # K=5 and eight 2048-sample kernel tiles.
        system = GPSL1()
        case = _random_case(system, 16384, 5, seed=3)
        _check_bank_vs_f64(algo, system, case)

    def test_wide_span_multi_antenna(self, algo):
        system = GPSL1()
        case = _random_case(system, 8192, 3, seed=6, num_ants=2)
        case["shifts"] = np.array([-160, 0, 170])
        got = _check_bank_vs_f64(algo, system, case)
        assert got.shape == (3, 2, 3)

    def test_unaligned_n(self, algo):
        system = GPSL1()
        _check_bank_vs_f64(algo, system, _random_case(system, 20000, 3, seed=5))


def test_xla_bank_matches():
    # The bank and the single-channel oracle path agree where their chip
    # arithmetic coincides (nominal rate, zero phases).
    system = GPSL1()
    N = 4096
    fs = N / 1e-3
    signal, _ = gen_signal(system, 2, 900.0, N)
    shifts = tuple(int(s) for s in
                   correlator_sample_shifts(system, EPLCorrelator(3), fs))
    sre, sim = soa(signal)
    got = run_bank("xla_bank", system, sre, sim, fs, shifts, [2, 2], 900.0)
    are, aim = jax.jit(functools.partial(
        registry.get("fused_xla"), sample_shifts=shifts,
        code_length=system.code_length))(
        sre, sim, jnp.asarray(system.codes), 2, 900.0, fs, 0.0,
        system.code_frequency, 0.0)
    np.testing.assert_allclose(got[0], np.asarray(are) + 1j * np.asarray(aim),
                               rtol=1e-5, atol=1e-2)


def test_registry_names():
    names = registry.names()
    for expected in ["bank", "fused_xla", "triton_bank", "unfused_xla",
                     "xla_bank"]:
        assert expected in names
    assert {"bank", "xla_bank", "triton_bank"} <= registry.BANK_ALGORITHMS
    with pytest.raises(KeyError):
        registry.get("nope")


def test_bank_is_the_plain_bank_off_the_gpu():
    # `bank` picks triton_bank only on the GPU; on the CPU it is xla_bank,
    # output for output.
    system = GPSL1()
    signal, fs = gen_signal(system, 0, 1500.0, 2500)
    sre, sim = soa(signal)
    shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
    got = run_bank("bank", system, sre, sim, fs, shifts, [0, 1], 1500.0)
    want = run_bank("xla_bank", system, sre, sim, fs, shifts, [0, 1], 1500.0)
    np.testing.assert_array_equal(got, want)


def test_scalar_channel_parameters():
    # Scalar parameters give one channel's [L] accumulators, so the bank
    # correlators also serve single-channel `track`.
    system = GPSL1()
    signal, fs = gen_signal(system, 0, 1500.0, 2500)
    sre, sim = soa(signal)
    shifts = (-1, 0, 1)
    for algo in BANKS:
        fn = functools.partial(bank_fn(algo), sample_shifts=shifts,
                               code_length=system.code_length,
                               sampling_frequency=fs)
        are, _ = fn(sre, sim, jnp.asarray(system.codes), 0, 1500.0,
                    carrier_phase=0.0, code_frequency=system.code_frequency,
                    code_phase=0.0)
        assert are.shape == (3,)
        np.testing.assert_allclose(np.asarray(are), GOLDEN, rtol=3.5e-4)


def test_wide_span_fused_native():
    # Tap span >= 128 samples through the single-channel fused path: L=7 at
    # 131 MHz, span 384 samples.
    system = GPSL1()
    N = 131072
    signal, fs = gen_signal(system, 0, 1500.0, N)
    shifts = correlator_sample_shifts(system, EPLCorrelator(7), fs)
    assert int(max(shifts)) - int(min(shifts)) >= 128
    sre, sim = soa(signal)
    are, aim = jax.jit(functools.partial(
        registry.get("fused_xla"), sample_shifts=tuple(int(s) for s in shifts),
        code_length=system.code_length))(
        sre, sim, jnp.asarray(system.codes), 0, 1500.0, fs, 0.0,
        system.code_frequency, 0.0)
    want = f64(system, signal, fs, shifts)
    np.testing.assert_allclose(np.asarray(are) + 1j * np.asarray(aim), want,
                               rtol=1e-3, atol=2.0)

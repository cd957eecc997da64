"""Correlator golden-value and oracle tests.

Mirrors the reference's golden-value strategy
(`/root/reference/test/algorithms.jl`): GPS L1 C/A, PRN 1, N = 2500 samples in
1 ms (f_s = 2.5 MHz), f_carrier = 1500 Hz, zero phases, noiseless -> EPL
accumulators exactly ``[1476, 2500, 1476]`` (prompt = N at perfect alignment).
An independent float64 numpy oracle cross-checks arbitrary scenarios.
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
from gpuacceleratedtracking_tpu.ops import (
    correlate_fused,
    correlate_unfused,
    gen_code_replica,
    gen_code_replica_quantized,
)

GOLDEN = np.array([1476.0, 2500.0, 1476.0])


def numpy_oracle(system, prn, carrier_freq, fs, carrier_phase, code_freq,
                 code_phase, num_samples, shifts, signal):
    """Float64 reference correlator (`bench.oracle`), independent of the
    JAX ops."""
    return oracle.correlate(
        np.asarray(signal)[..., :num_samples], system.codes, prn,
        carrier_freq, fs, carrier_phase, code_freq, code_phase, shifts)


def run_fused(system, signal, fs, shifts, *, prn=0, fcar=1500.0, phicar=0.0,
              fcode=None, phicode=0.0, variant=correlate_fused):
    sre, sim = soa(signal)
    fn = jax.jit(
        functools.partial(
            variant, sample_shifts=tuple(int(s) for s in shifts),
            code_length=system.code_length,
        )
    )
    are, aim = fn(
        sre, sim, jnp.asarray(system.codes), prn, fcar, fs, phicar,
        fcode if fcode is not None else system.code_frequency, phicode,
    )
    return np.asarray(are) + 1j * np.asarray(aim)


class TestGoldenValues:
    @pytest.fixture(scope="class")
    def scenario(self):
        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 2500)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        return system, signal, fs, shifts

    def test_shifts(self, scenario):
        _, _, _, shifts = scenario
        np.testing.assert_array_equal(shifts, [-1, 0, 1])

    def test_fused_golden(self, scenario):
        system, signal, fs, shifts = scenario
        acc = run_fused(system, signal, fs, shifts)
        np.testing.assert_allclose(acc.real, GOLDEN, rtol=3.5e-4)
        np.testing.assert_allclose(acc.imag, 0.0, atol=0.5)

    def test_unfused_golden(self, scenario):
        system, signal, fs, shifts = scenario
        acc = run_fused(system, signal, fs, shifts, variant=correlate_unfused)
        np.testing.assert_allclose(acc.real, GOLDEN, rtol=3.5e-4)

    def test_multi_antenna_golden(self, scenario):
        # The M=4 scenario of `/root/reference/test/algorithms.jl:599-743`.
        system, _, fs, shifts = scenario
        signal, _ = gen_signal(system, 0, 1500.0, 2500, num_ants=4)
        acc = run_fused(system, signal, fs, shifts)
        assert acc.shape == (4, 3)
        for a in range(4):
            np.testing.assert_allclose(acc[a].real, GOLDEN, rtol=3.5e-4)

    def test_seven_correlators(self, scenario):
        system, signal, fs, _ = scenario
        shifts = correlator_sample_shifts(system, EPLCorrelator(7), fs)
        np.testing.assert_array_equal(shifts, [-3, -2, -1, 0, 1, 2, 3])
        acc = run_fused(system, signal, fs, shifts)
        assert acc.shape == (7,)
        assert abs(acc[3].real - 2500.0) < 1.0
        # Magnitude decays moving off the prompt.
        mags = np.abs(acc.real)
        assert np.all(np.diff(mags[:4]) > 0) and np.all(np.diff(mags[3:]) < 0)


class TestAgainstOracle:
    @pytest.mark.parametrize("fcar,phicar,phicode,prn", [
        (1500.0, 0.0, 0.0, 0),
        (-2600.0, 1.2, 345.6, 7),
        (4321.0, -0.4, 1022.9, 31),
    ])
    def test_l1_matches_float64_oracle(self, fcar, phicar, phicode, prn):
        system = GPSL1()
        N = 4096
        signal, fs = gen_signal(
            system, prn, fcar, N, start_code_phase=phicode, start_carrier_phase=phicar
        )
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        acc = run_fused(system, signal, fs, shifts, prn=prn, fcar=fcar,
                        phicar=phicar, phicode=phicode)
        ref = numpy_oracle(system, prn, fcar, fs, phicar, system.code_frequency,
                           phicode, N, shifts, np.asarray(signal))
        np.testing.assert_allclose(acc, ref, rtol=2e-3, atol=0.6)

    def test_l5_matches_float64_oracle(self):
        system = GPSL5()
        N = 32768  # 32.768 MHz sampling, above the L5 Nyquist envelope
        signal, fs = gen_signal(system, 0, 1000.0, N)
        shifts = correlator_sample_shifts(system, EPLCorrelator(3), fs)
        np.testing.assert_array_equal(shifts, [-2, 0, 2])
        acc = run_fused(system, signal, fs, shifts, fcar=1000.0)
        ref = numpy_oracle(system, 0, 1000.0, fs, 0.0, system.code_frequency,
                           0.0, N, shifts, np.asarray(signal))
        np.testing.assert_allclose(acc, ref, rtol=2e-3, atol=2.0)
        assert abs(acc[1].real - N) < 2.0

    def test_multi_satellite_bank_vmap(self):
        # The 3-D multi-sat scenario (`test/algorithms.jl:1159-1313`, K=4, M=4).
        system = GPSL1()
        N, K, A = 2048, 4, 4
        prns = np.arange(K)
        signal, fs = gen_signal(system, prns, 1500.0, N, num_ants=A)
        assert signal.shape == (K, A, N)
        shifts = tuple(
            int(s) for s in correlator_sample_shifts(system, EPLCorrelator(3), fs)
        )
        sre, sim = soa(signal)
        codes = jnp.asarray(system.codes)

        @jax.jit
        def bank(sre, sim, prns):
            def one(sr, si, prn):
                return correlate_fused(
                    sr, si, codes, prn, 1500.0, fs, 0.0,
                    system.code_frequency, 0.0, shifts, system.code_length,
                )
            return jax.vmap(one)(sre, sim, prns)

        are, aim = bank(sre, sim, jnp.asarray(prns))
        assert are.shape == (K, A, 3)
        for k in range(K):
            ref = numpy_oracle(system, k, 1500.0, fs, 0.0,
                               system.code_frequency, 0.0, N, shifts,
                               np.asarray(signal)[k])
            np.testing.assert_allclose(
                np.asarray(are)[k] + 1j * np.asarray(aim)[k], ref,
                rtol=2e-3, atol=0.6,
            )


class TestQuantizedReplica:
    def test_error_envelope(self):
        """Quantized-NCO replica error vs exact replica — the counterpart of
        `scripts/code_replica_experiment.jl` (texture error: mean 0.03 %,
        max 3.17 %)."""
        system = GPSL1()
        rel_errors = []
        for N in [2048, 5000, 16384, 65536]:
            fs = N / 1e-3
            exact = jax.jit(
                functools.partial(
                    gen_code_replica, num_samples=N, min_shift=0, max_shift=0,
                    code_length=system.code_length,
                )
            )(jnp.asarray(system.codes), 0, system.code_frequency, fs, 0.0)
            quant = jax.jit(
                functools.partial(
                    gen_code_replica_quantized, num_samples=N, min_shift=0,
                    max_shift=0, code_length=system.code_length,
                )
            )(jnp.asarray(system.codes), 0, system.code_frequency, fs, 0.0)
            rel_errors.append(float(jnp.mean(exact != quant)))
        # The 12-bit fixed-point NCO beats the reference texture path's whole
        # envelope (mean 0.03 %, max 3.17 %): mean <= 0.01 %, max <= 0.05 %.
        assert np.mean(rel_errors) <= 1e-4, rel_errors
        assert np.max(rel_errors) <= 5e-4, rel_errors


class TestCoherentIntegration:
    """Multi-millisecond coherent integration — the Tracking.jl capability of
    extending the integration block beyond one code period. No kernel change
    is needed: the replica wraps mod code_length, so a 2 ms block simply spans
    two code periods and EPL doubles ([2952, 5000, 2952] for the golden
    scenario at 2x duration)."""

    @pytest.mark.parametrize("algo", ["fused_xla", "xla_bank", "triton_bank"])
    def test_two_ms_block(self, algo):
        from gpuacceleratedtracking_tpu.ops import registry
        from gpuacceleratedtracking_tpu.ops.triton_bank import (
            correlate_triton_bank,
        )

        system = GPSL1()
        signal, fs = gen_signal(system, 0, 1500.0, 5000, duration=2e-3)
        sre, sim = soa(signal)
        shifts = tuple(
            int(s)
            for s in correlator_sample_shifts(system, EPLCorrelator(3), fs)
        )
        corr = registry.get(algo)
        if algo == "triton_bank":
            corr = functools.partial(correlate_triton_bank, interpret=True)
        if algo != "fused_xla":
            are, _ = corr(
                sre, sim, jnp.asarray(system.codes), jnp.zeros(1, jnp.int32),
                jnp.full(1, 1500.0), fs, jnp.zeros(1),
                jnp.full(1, system.code_frequency), jnp.zeros(1),
                sample_shifts=shifts, code_length=system.code_length,
            )
            are = np.asarray(are)[0]
        else:
            are, _ = corr(
                sre, sim, jnp.asarray(system.codes), 0, 1500.0, fs, 0.0,
                system.code_frequency, 0.0, shifts, system.code_length,
            )
            are = np.asarray(are)
        np.testing.assert_allclose(are, [2952.0, 5000.0, 2952.0], rtol=1e-4)


class TestDownconvertOnly:
    """Downconvert-only unit tests — the reference's `downconvert_strided_
    kernel!` correctness check (`/root/reference/test/algorithms.jl:1379-1436`):
    wiping off the very carrier the signal was generated with must leave
    exactly the code replica (unit amplitude, zero residual phase)."""

    def test_downconverted_equals_code_replica(self):
        from gpuacceleratedtracking_tpu.ops.correlate import downconvert

        system = GPSL1()
        num_samples, fcar = 2500, 1500.0
        fs = num_samples / 1e-3
        signal, _ = gen_signal(system, 0, fcar, num_samples)
        sre, sim = soa(signal)
        n = jnp.arange(num_samples, dtype=jnp.float32)
        theta = 2 * np.pi * fcar / fs * n
        dw_re, dw_im = downconvert(sre, sim, jnp.cos(theta), jnp.sin(theta))
        rep = gen_code_replica(
            jnp.asarray(system.codes), 0, system.code_frequency, fs, 0.0,
            num_samples, 0, 0, system.code_length,
        )
        np.testing.assert_allclose(np.asarray(dw_re), np.asarray(rep),
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(dw_im), 0.0, atol=5e-4)

    def test_downconvert_broadcasts_antennas(self):
        from gpuacceleratedtracking_tpu.ops.correlate import downconvert

        system = GPSL1()
        num_samples, fcar = 2500, 1500.0
        fs = num_samples / 1e-3
        signal, _ = gen_signal(system, 0, fcar, num_samples, num_ants=4)
        sre, sim = soa(signal)
        n = jnp.arange(num_samples, dtype=jnp.float32)
        theta = 2 * np.pi * fcar / fs * n
        dw_re, dw_im = downconvert(sre, sim, jnp.cos(theta), jnp.sin(theta))
        assert dw_re.shape == (4, num_samples)
        # identical per antenna (reference generates identical antenna copies)
        np.testing.assert_allclose(np.asarray(dw_re[0]), np.asarray(dw_re[3]))
        np.testing.assert_allclose(np.asarray(dw_im), 0.0, atol=5e-4)


def test_precise_div_exact_under_jit():
    # XLA lowers a traced f32 divide to reciprocal-multiply (1-2 ulp off):
    # rho = 2046000/8184000 must be EXACTLY 0.25 under jit, or every
    # exactly-on-sample chip boundary shifts a whole sample (the Galileo E1
    # grid bug, round 5). precise_div guarantees correct rounding for
    # static denominators.
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuacceleratedtracking_tpu.ops.replica import precise_div

    def naive(x):
        return x / 8184000.0

    def precise(x):
        return precise_div(x, 8184000.0)

    x = jnp.float32(2046000.0)
    assert float(jax.jit(precise)(x)) == 0.25
    # Document the underlying hazard: if the naive jit path ever becomes
    # exact on this backend too, the helper is still correct (no-op).
    for num, den, want in [(1023000.0, 2046000.0, 0.5),
                           (2046000.0, 32768000.0, 2046.0 / 32768.0)]:
        got = float(jax.jit(lambda v: precise_div(v, den))(jnp.float32(num)))
        np.testing.assert_allclose(got, np.float32(want), rtol=0, atol=0)

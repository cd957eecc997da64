"""GLONASS L1OF model-family tests: m-sequence structure + FDMA bank tracking.

The reference supports only GPS L1/L5 (`GNSSDICT`,
`/root/reference/src/GPUAcceleratedTracking.jl:39-42`); GLONASS L1OF exercises
the framework's generality: a different code length (511, not a multiple of
128), a shared spreading code, and satellite separation by per-channel carrier
frequency — which the channel bank carries natively.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuacceleratedtracking_tpu.models import (
    EPLCorrelator,
    GLONASSL1,
    correlator_sample_shifts,
    gen_signal,
    get_system,
    glonass_l1,
    soa,
)
from gpuacceleratedtracking_tpu.ops import correlate_fused
from gpuacceleratedtracking_tpu.ops.registry import get as get_algorithm


class TestMSequence:
    def test_table_shape_and_chips(self):
        t = glonass_l1.code_table()
        assert t.shape == (511, 14)
        assert set(np.unique(t)) == {-1.0, 1.0}
        # FDMA: every frequency-channel column carries the same code.
        assert np.all(t == t[:, :1])

    def test_balance(self):
        # Maximal-length sequence: 256 ones, 255 zeros -> +/-1 chips sum to 1.
        assert glonass_l1.code_table()[:, 0].sum() == 1.0

    def test_two_valued_autocorrelation(self):
        # The defining m-sequence property: circular autocorrelation is 511 at
        # lag 0 and exactly -1 at every other lag. This fails for any wrong
        # tap/output choice that breaks maximality.
        c = glonass_l1.code_table()[:, 0].astype(np.float64)
        ac = np.fft.ifft(np.fft.fft(c) * np.conj(np.fft.fft(c))).real.round()
        assert ac[0] == 511.0
        assert np.all(ac[1:] == -1.0)

    def test_carrier_frequencies(self):
        assert glonass_l1.carrier_frequency(0) == 1.602e9
        assert glonass_l1.carrier_frequency(-7) == pytest.approx(1598.0625e6)
        assert glonass_l1.carrier_frequency(6) == pytest.approx(1605.375e6)
        with pytest.raises(ValueError):
            glonass_l1.carrier_frequency(7)

    def test_registry(self):
        sys_ = get_system("GLONASSL1")
        assert sys_.code_length == 511
        assert sys_.code_frequency == 0.511e6
        assert sys_.code_period() == pytest.approx(1e-3)


def _oracle(system, prn, fcar, fs, signal, shifts):
    n = np.arange(signal.shape[-1], dtype=np.float64)
    carrier = np.exp(1j * (2 * np.pi * fcar / fs * n))
    dw = np.asarray(signal).astype(np.complex128) * np.conj(carrier)
    out = []
    for d in shifts:
        idx = np.mod(
            np.floor(system.code_frequency / fs * (n + d)).astype(np.int64),
            system.code_length,
        )
        out.append(np.sum(dw * system.codes[idx, prn].astype(np.float64)))
    return np.array(out)


class TestCorrelation:
    def test_fused_matches_oracle(self):
        system = GLONASSL1()
        N = 2048
        fs = N / 1e-3
        fcar = 2500.0
        signal, _ = gen_signal(system, 0, fcar, N)
        shifts = tuple(
            int(s)
            for s in correlator_sample_shifts(system, EPLCorrelator(3), fs)
        )
        sre, sim = soa(signal)
        are, aim = jax.jit(
            functools.partial(
                correlate_fused, sample_shifts=shifts,
                code_length=system.code_length,
            )
        )(sre, sim, jnp.asarray(system.codes), 0, fcar, fs, 0.0,
          system.code_frequency, 0.0)
        got = np.asarray(are) + 1j * np.asarray(aim)
        want = _oracle(system, 0, fcar, fs, np.asarray(signal), shifts)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.3)
        # Prompt at perfect alignment = N.
        assert got[1].real == pytest.approx(N, rel=1e-5)

    def test_fdma_bank_kernel(self, bank_algorithm):
        # K channels, same code, distinct FDMA carrier offsets: the bank
        # kernel's per-channel carrier frequency is exactly the FDMA split.
        system = GLONASSL1()
        N, K = 2048, 4
        fs = N / 1e-3
        # Scaled-down FDMA-style IF offsets (baseband test scenario).
        fcars = np.array([1000.0, 3000.0, 5000.0, 7000.0])
        sigs = [np.asarray(gen_signal(system, 0, f, N)[0]) for f in fcars]
        mixed = np.sum(sigs, axis=0)
        shifts = tuple(
            int(s)
            for s in correlator_sample_shifts(system, EPLCorrelator(3), fs)
        )
        sre = jnp.asarray(mixed.real, jnp.float32)
        sim = jnp.asarray(mixed.imag, jnp.float32)
        bank = jax.jit(
            functools.partial(
                get_algorithm(bank_algorithm),
                sample_shifts=shifts,
                code_length=system.code_length,
                sampling_frequency=fs,
            )
        )
        prns = jnp.zeros(K, jnp.int32)
        are, aim = bank(
            sre, sim, jnp.asarray(system.codes), prns,
            jnp.asarray(fcars, jnp.float32),
            carrier_phase=jnp.zeros(K, jnp.float32),
            code_frequency=jnp.full((K,), system.code_frequency, jnp.float32),
            code_phase=jnp.zeros(K, jnp.float32),
        )
        got = np.asarray(are) + 1j * np.asarray(aim)
        for k in range(K):
            want = _oracle(system, 0, fcars[k], fs, mixed, shifts)
            np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=1.0)
            # Each channel's prompt sees its own satellite at full power.
            assert got[k, 1].real > 0.9 * N

    def test_fdma_rows_kernel(self, bank_algorithm):
        # GLONASS L1OF through the bank at 8.192 MHz (0.511 Mchip/s: ~16
        # samples per chip).
        system = GLONASSL1()
        N, K = 8192, 3
        fs = N / 1e-3
        fcars = np.array([-2000.0, 1000.0, 4000.0])
        sigs = [np.asarray(gen_signal(system, 0, f, N)[0]) for f in fcars]
        mixed = np.sum(sigs, axis=0)
        shifts = tuple(
            int(s)
            for s in correlator_sample_shifts(system, EPLCorrelator(3), fs)
        )
        bank = jax.jit(
            functools.partial(
                get_algorithm(bank_algorithm),
                sample_shifts=shifts,
                code_length=system.code_length,
                sampling_frequency=fs,
            )
        )
        are, aim = bank(
            jnp.asarray(mixed.real, jnp.float32),
            jnp.asarray(mixed.imag, jnp.float32),
            jnp.asarray(system.codes), jnp.zeros(K, jnp.int32),
            jnp.asarray(fcars, jnp.float32),
            carrier_phase=jnp.zeros(K, jnp.float32),
            code_frequency=jnp.full((K,), system.code_frequency, jnp.float32),
            code_phase=jnp.zeros(K, jnp.float32),
        )
        got = np.asarray(are) + 1j * np.asarray(aim)
        for k in range(K):
            want = _oracle(system, 0, fcars[k], fs, mixed, shifts)
            np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=1.5)
            assert got[k, 1].real > 0.9 * N

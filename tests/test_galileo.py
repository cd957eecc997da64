"""Galileo E1 BOC(1,1) model-family tests (fourth constellation family).

The reference supports only GPS L1/L5 (`GNSSDICT`,
`/root/reference/src/GPUAcceleratedTracking.jl:39-42`). E1's BOC(1,1)
meander — a sign flip MID-chip — doubles the chip-transition density the
bank correlators must place, making it their stress test. The subcarrier is folded into the code table
(half-chip pairs), so every correlator kernel runs unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuacceleratedtracking_tpu.models import (
    EPLCorrelator,
    GalileoE1,
    correlator_sample_shifts,
    galileo_e1,
    gen_signal,
    get_system,
    soa,
)
from gpuacceleratedtracking_tpu.ops.registry import get as get_algorithm
from gpuacceleratedtracking_tpu.tracking import (
    TrackConfig,
    init_state,
    track_bank,
)


class TestCodes:
    def test_table_structure(self):
        t = galileo_e1.code_table()
        assert t.shape == (8184, 50)
        assert set(np.unique(t)) == {-1.0, 1.0}
        # The BOC(1,1) meander: the second half-chip of every chip is the
        # negated first half.
        np.testing.assert_array_equal(t[1::2], -t[0::2])
        # Data (E1-B) and pilot (E1-C) components carry distinct codes.
        assert not np.array_equal(t, galileo_e1.code_table(pilot=True))

    def test_boc_autocorrelation_shape(self):
        # BOC(1,1) circular autocorrelation in the half-chip domain: peak
        # 8184 at lag 0, ~-0.5 peak at +/-1 half-chip (the meander's
        # signature negative sidelobe — absent for plain BPSK codes).
        c = galileo_e1.code_table()[:, 0].astype(np.float64)
        ac = np.fft.ifft(np.fft.fft(c) * np.conj(np.fft.fft(c))).real
        assert ac[0] == pytest.approx(8184.0)
        assert ac[1] < -0.4 * 8184
        assert ac[-1] < -0.4 * 8184

    def test_registry_and_period(self):
        b = get_system("GALILEOE1B")
        c = get_system("GALILEOE1C")
        assert b.code_length == 8184
        assert b.code_frequency == pytest.approx(2.046e6)
        assert b.code_period() == pytest.approx(4e-3)   # 4 ms primary period
        assert b.secondary_code is None
        assert c.secondary_code.shape == (25,)
        assert set(np.unique(c.secondary_code)) == {-1.0, 1.0}

    def test_icd_loader_roundtrip(self):
        # load_primary_codes accepts 50 hex rows of 4092 bits MSB-first and
        # BOC-expands them; feeding it a known bit pattern must reproduce
        # the expansion exactly.
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, size=(50, 4092), dtype=np.uint8)
        rows = []
        for r in bits:
            padded = np.concatenate([r, np.zeros(4096 - 4092, np.uint8)])
            rows.append("".join(
                f"{int(''.join(map(str, padded[i:i+4])), 2):x}"
                for i in range(0, 4096, 4)
            ))
        table = galileo_e1.load_primary_codes(rows)
        assert table.shape == (8184, 50)
        np.testing.assert_array_equal(
            table[0::2], bits.T.astype(np.float32) * 2.0 - 1.0
        )


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
    def test_golden_prompt(self):
        # 8.184 MHz, 1 ms block = 8184 samples = exactly 4 samples per
        # half-chip, a QUARTER of the 4 ms primary period (partial-period
        # integration — standard once code-locked). Perfect alignment:
        # prompt == N exactly.
        system = GalileoE1()
        N = 8184
        fs = N / 1e-3
        signal, _ = gen_signal(system, 0, 1000.0, N)
        shifts = tuple(int(s) for s in correlator_sample_shifts(
            system, EPLCorrelator(3), fs))
        sre, sim = soa(signal)
        are, aim = jax.jit(functools.partial(
            get_algorithm("fused_xla"), sample_shifts=shifts,
            code_length=system.code_length,
        ))(sre, sim, jnp.asarray(system.codes), 0, 1000.0, fs, 0.0,
           system.code_frequency, 0.0)
        got = np.asarray(are) + 1j * np.asarray(aim)
        want = _oracle(system, 0, 1000.0, fs, np.asarray(signal), shifts)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.5)
        assert got[1].real == pytest.approx(N, rel=1e-5)
        # The BOC sidelobe: +/-0.5 half-chip taps sit on the meander's
        # falling edge, so early/late are far below a BPSK code's 0.75 N.
        assert abs(got[0].real) < 0.6 * N

    @pytest.mark.parametrize("n_samples", [8192, 32768])
    def test_bank_kernels_boc_meander(self, n_samples, bank_algorithm):
        # The meander stress test: the bank must reconstruct a replica with
        # a transition at EVERY half-chip boundary. Parity vs the float64
        # oracle on randomized channels.
        from gpuacceleratedtracking_tpu.bench import oracle

        system = GalileoE1()
        K = 3
        fs = n_samples / 1e-3
        rng = np.random.default_rng(4)
        signal, _ = gen_signal(system, 0, 1500.0, n_samples)
        sre, sim = soa(signal)
        dops = (1500.0 + rng.uniform(-3000, 3000, K)).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, K).astype(np.float32)
        cph = rng.uniform(0, system.code_length, K).astype(np.float32)
        shifts = tuple(int(s) for s in correlator_sample_shifts(
            system, EPLCorrelator(3), fs))
        fn = jax.jit(functools.partial(
            get_algorithm(bank_algorithm), sample_shifts=shifts,
            code_length=system.code_length, sampling_frequency=fs,
        ))
        are, aim = fn(
            sre, sim, jnp.asarray(system.codes),
            jnp.arange(K, dtype=jnp.int32), jnp.asarray(dops),
            carrier_phase=jnp.asarray(phases),
            code_frequency=jnp.full((K,), system.code_frequency, jnp.float32),
            code_phase=jnp.asarray(cph),
        )
        got = np.asarray(are) + 1j * np.asarray(aim)
        for k in range(K):
            want = oracle.correlate(
                signal, system.codes, k, float(dops[k]), fs, float(phases[k]),
                float(np.float32(system.code_frequency)), float(cph[k]),
                shifts)
            np.testing.assert_allclose(got[k].real, want.real, rtol=2e-3,
                                       atol=9.0)
            np.testing.assert_allclose(got[k].imag, want.imag, rtol=2e-3,
                                       atol=9.0)


class TestAcquisition:
    def test_pcps_finds_e1_satellites(self):
        # PCPS over one FULL 4 ms primary period (the E1 acquisition block:
        # circular correlation needs an integer number of code periods —
        # exactly one here). Code phase estimates come back in half-chips.
        from gpuacceleratedtracking_tpu.acquire import acquire
        from gpuacceleratedtracking_tpu.models import gen_signal_mixed

        system = GalileoE1()
        prns = np.array([3, 17])
        dops = np.array([900.0, -2100.0])
        phases = np.array([1200.5, 5000.25])    # half-chips
        N = 16368                                # 4 ms at 4.092 MHz
        sig, fs = gen_signal_mixed(
            system, prns, dops, N, duration=4e-3,
            start_code_phases=phases,
        )
        sre, sim = soa(sig)
        res = acquire(system, sre, sim, prns, fs, max_doppler=3000.0)
        got_dop = np.asarray(res.carrier_doppler)
        # 4 ms coherent block -> 167 Hz doppler bins: within one bin.
        assert np.all(np.abs(got_dop - dops) < 100.0), got_dop
        err = np.abs(np.asarray(res.code_phase) - phases)
        err = np.minimum(err, system.code_length - err)
        assert np.all(err < 0.6), res.code_phase   # within one sample
        assert np.all(np.asarray(res.peak_metric) > 10.0)


class TestClosedLoop:
    def test_e1b_data_channel_costas(self):
        # E1-B (data component): 250 sps nav symbols = one sign per 4 ms
        # primary period, no overlay. The default Costas discriminators are
        # symbol-sign-invariant; Doppler must converge through random data.
        system = GalileoE1()           # E1-B
        N, num_ms, K = 8192, 200, 2
        fs = N / 1e-3
        dops = np.array([600.0, -900.0])
        rng = np.random.default_rng(8)
        sigs = []
        for prn, d in enumerate(dops):
            scale = 1.0 + d / system.center_frequency
            symbols = rng.choice([-1.0, 1.0], num_ms // 4 + 2)
            s, _ = gen_signal(
                system, prn, d, N * num_ms, duration=num_ms * 1e-3,
                code_frequency=system.code_frequency * scale,
                secondary_code=symbols,    # one sign per 4 ms period
            )
            sigs.append(s)
        mixed = sigs[0] + sigs[1]
        sre, sim = (np.asarray(x).reshape(num_ms, N) for x in soa(mixed))
        config = TrackConfig.for_system(
            system, fs, N, algorithm="xla_bank",
        )
        assert config.secondary_code == ()     # nothing to wipe: data, not NH
        states = init_state(np.arange(K), carrier_doppler=dops + 25.0)
        _, out = track_bank(
            config, jnp.asarray(system.codes), states,
            jnp.asarray(sre), jnp.asarray(sim),
        )
        final_dop = np.asarray(out.carrier_doppler)[-20:].mean(axis=0)
        np.testing.assert_allclose(final_dop, dops, atol=5.0)
        p = np.hypot(
            np.asarray(out.prompt_re)[-20:], np.asarray(out.prompt_im)[-20:]
        )
        assert np.all(p > 0.6 * N), p.min()

    def test_pilot_tracks_with_cs25_overlay(self):
        # E1-C closed loop: CS25 overlay wipe-off across the 4 ms primary
        # period (one sign per 4 blocks — `TrackConfig.for_system` expands
        # it per-ms), dataless atan2 PLL. Doppler must converge.
        # fs = 8.192 MHz, NOT an exact multiple of the 2.046 MHz half-chip
        # rate: a commensurate grid (e.g. 8.184 MHz) makes the replica's
        # integer-sample chip grid snap a whole sample whenever accumulated
        # f32 phase error crosses a grid point — the classic code-NCO
        # quantization limit cycle every receiver avoids by sampling
        # non-commensurately (the loop still self-corrects, but |P| dips
        # ~0.63 N for ~15 blocks at each crossing).
        system = GalileoE1(pilot=True)
        N, num_ms, K = 8192, 240, 2
        fs = N / 1e-3
        dops = np.array([800.0, -1400.0])
        sigs = []
        for prn, d in enumerate(dops):
            scale = 1.0 + d / system.center_frequency
            s, _ = gen_signal(
                system, prn, d, N * num_ms, duration=num_ms * 1e-3,
                code_frequency=system.code_frequency * scale,
                secondary_code=system.secondary_code,
            )
            sigs.append(s)
        mixed = sigs[0] + sigs[1]
        sre, sim = (np.asarray(x).reshape(num_ms, N) for x in soa(mixed))
        config = TrackConfig.for_system(
            system, fs, N, algorithm="xla_bank",
            pll_discriminator="atan2",
        )
        assert len(config.secondary_code) == 100   # 25 signs x 4 blocks
        # 30 Hz initial Doppler error: inside the pull-in range.
        states = init_state(np.arange(K), carrier_doppler=dops + 30.0)
        _, out = track_bank(
            config, jnp.asarray(system.codes), states,
            jnp.asarray(sre), jnp.asarray(sim),
        )
        final_dop = np.asarray(out.carrier_doppler)[-20:].mean(axis=0)
        np.testing.assert_allclose(final_dop, dops, atol=5.0)
        # Locked prompt power (|P|: the 3rd-order PLL's phase ring-down
        # outlasts 240 blocks — CLAUDE.md convergence note — so code lock is
        # asserted on magnitude, like the GPS closed-loop tests).
        p = np.hypot(
            np.asarray(out.prompt_re)[-20:], np.asarray(out.prompt_im)[-20:]
        )
        assert np.all(p > 0.7 * N), p.min()

"""BeiDou B1I model-family tests (fifth constellation family).

The reference supports only GPS L1/L5 (`GNSSDICT`,
`/root/reference/src/GPUAcceleratedTracking.jl:39-42`). B1I is the first
fully register-generated family beyond GPS here: the real ICD generator
(two 11-stage LFSRs, per-PRN G2 phase-assignment pairs, 2047 -> 2046
truncation) rather than Galileo's documented stand-in memory codes — so
these tests pin the ICD structure itself (maximality of both base
sequences, the shift-and-add identity behind the tap-pair table, the
truncated-Gold balance signature), then run the standard correlation /
acquisition / closed-loop ladder through unchanged kernels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuacceleratedtracking_tpu.models import (
    BeiDouB1I,
    EPLCorrelator,
    beidou_b1i,
    correlator_sample_shifts,
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


def _lfsr_out(feedback, length=2047):
    """Stage-11 output bits of an 11-stage LFSR from the module's constants."""
    reg = beidou_b1i._INIT.copy()
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        out[i] = reg[10]
        fb = np.bitwise_xor.reduce(reg[[s - 1 for s in feedback]])
        reg = np.concatenate(([fb], reg[:10]))
    return out


class TestCodes:
    def test_table_structure(self):
        t = beidou_b1i.code_table()
        assert t.shape == (2046, 37)
        assert set(np.unique(t)) == {-1.0, 1.0}
        # All 37 phase assignments yield distinct codes.
        assert len({tuple(t[:, i]) for i in range(37)}) == 37

    def test_truncated_gold_balance(self):
        # A full-period (2047) Gold chip sum is +/-1; dropping exactly one
        # chip moves it to {0, +/-2}. Random or mis-generated sequences
        # fail this with overwhelming probability (std ~ sqrt(2046) ~ 45).
        sums = beidou_b1i.code_table().sum(axis=0)
        assert set(np.unique(sums)).issubset({-2.0, 0.0, 2.0}), sums

    def test_base_sequences_are_maximal(self):
        # Both generator polynomials must be primitive: the stage-11 output
        # over 2047 steps has the two-valued m-sequence autocorrelation
        # (2047 at lag 0, exactly -1 elsewhere). Catches any wrong feedback
        # tap in _G1_FEEDBACK/_G2_FEEDBACK.
        for fb in (beidou_b1i._G1_FEEDBACK, beidou_b1i._G2_FEEDBACK):
            c = _lfsr_out(fb).astype(np.float64) * 2.0 - 1.0
            ac = np.fft.ifft(np.fft.fft(c) * np.conj(np.fft.fft(c))).real
            ac = ac.round()
            assert ac[0] == 2047.0
            assert np.all(ac[1:] == -1.0)

    def test_tap_pairs_are_g2_shifts(self):
        # Shift-and-add: XOR of two stages of an m-sequence register is a
        # cyclic shift of the sequence itself, so every PRN's G2 component
        # must be a distinct rotation of the base G2 output. Catches tap
        # table typos/duplicates independently of the balance test.
        g2_base = _lfsr_out(beidou_b1i._G2_FEEDBACK)
        # Stage-j output leads the stage-11 output by (11 - j) steps.
        reg_hist = np.empty((2047, 11), dtype=np.uint8)
        reg = beidou_b1i._INIT.copy()
        for i in range(2047):
            reg_hist[i] = reg
            fb = np.bitwise_xor.reduce(
                reg[[s - 1 for s in beidou_b1i._G2_FEEDBACK]])
            reg = np.concatenate(([fb], reg[:10]))
        shifts = set()
        for t1, t2 in beidou_b1i._G2_TAPS:
            pair = reg_hist[:, t1 - 1] ^ reg_hist[:, t2 - 1]
            # Find the rotation d with pair == roll(g2_base, d).
            matches = [
                d for d in range(2047)
                if np.array_equal(pair, np.roll(g2_base, d))
            ]
            assert len(matches) == 1, (t1, t2, len(matches))
            shifts.add(matches[0])
        assert len(shifts) == 37   # all-distinct code-phase offsets

    def test_registry_and_secondary(self):
        s = get_system("BEIDOUB1I")
        assert s.code_length == 2046
        assert s.code_frequency == pytest.approx(2.046e6)
        assert s.code_period() == pytest.approx(1e-3)
        assert s.center_frequency == pytest.approx(1.561098e9)
        # D1 NH overlay is the SAME published NH20 sequence as GPS L5 Q5.
        from gpuacceleratedtracking_tpu.models import GPSL5

        np.testing.assert_array_equal(
            s.secondary_code, GPSL5(quadrature=True).secondary_code)
        assert BeiDouB1I(with_secondary=False).secondary_code is None


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
        # 8.184 MHz, 1 ms block = 8184 samples = exactly 4 samples/chip and
        # exactly one primary period. Perfect alignment: prompt == N.
        system = BeiDouB1I()
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
        # At 4 samples/chip the EPL spacing rounds to exactly 0.5 chip, so
        # the early tap disagrees on the 2 trailing samples of every
        # transition chip: E ~ N * (1 - transitions/2046) ~ 0.48 N — and,
        # code being periodic and alignment perfect, E == L exactly.
        assert 0.4 * N < got[0].real < 0.6 * N
        assert got[0].real == pytest.approx(got[2].real, abs=1.0)

    @pytest.mark.parametrize("n_samples", [8192, 32768])
    def test_bank_kernels(self, n_samples, bank_algorithm):
        # Parity vs the float64 oracle on randomized channels, at double GPS
        # L1's transition density (2046 chips/ms).
        from gpuacceleratedtracking_tpu.bench import oracle

        system = BeiDouB1I()
        K = 3
        fs = n_samples / 1e-3
        rng = np.random.default_rng(11)
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
                                       atol=6.0)
            np.testing.assert_allclose(got[k].imag, want.imag, rtol=2e-3,
                                       atol=6.0)


class TestAcquisition:
    def test_pcps_finds_b1i_satellites(self):
        # PCPS over one 1 ms primary period (like GPS L1 — B1I's code
        # period matches its block cadence, unlike E1's 4 ms).
        from gpuacceleratedtracking_tpu.acquire import acquire
        from gpuacceleratedtracking_tpu.models import gen_signal_mixed

        system = BeiDouB1I(with_secondary=False)
        prns = np.array([4, 21])
        dops = np.array([1250.0, -2400.0])
        phases = np.array([300.25, 1700.5])
        N = 8192
        sig, fs = gen_signal_mixed(
            system, prns, dops, N, start_code_phases=phases,
        )
        sre, sim = soa(sig)
        res = acquire(system, sre, sim, prns, fs, max_doppler=4000.0)
        got_dop = np.asarray(res.carrier_doppler)
        # 1 ms coherent block -> ~667 Hz bins: within half a bin.
        assert np.all(np.abs(got_dop - dops) < 400.0), got_dop
        err = np.abs(np.asarray(res.code_phase) - phases)
        err = np.minimum(err, system.code_length - err)
        assert np.all(err < 0.3), res.code_phase   # within one sample
        assert np.all(np.asarray(res.peak_metric) > 10.0)


class TestClosedLoop:
    def test_d1_tracks_with_nh20_overlay(self):
        # D1 closed loop: NH20 wipe-off (one sign per 1 ms block) through
        # the standard secondary-code path, Costas discriminators (D1
        # carries 50 bps data on top of NH — the default dot/atan Costas
        # loop is bit-sign-invariant). fs = 8.192 MHz is deliberately
        # non-commensurate with the 2.046 MHz chip rate (code-NCO
        # quantization limit cycle — CLAUDE.md).
        system = BeiDouB1I()
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
        )
        assert len(config.secondary_code) == 20   # 1 ms period: no expansion
        states = init_state(np.arange(K), carrier_doppler=dops + 30.0)
        _, out = track_bank(
            config, jnp.asarray(system.codes), states,
            jnp.asarray(sre), jnp.asarray(sim),
        )
        final_dop = np.asarray(out.carrier_doppler)[-20:].mean(axis=0)
        np.testing.assert_allclose(final_dop, dops, atol=5.0)
        p = np.hypot(
            np.asarray(out.prompt_re)[-20:], np.asarray(out.prompt_im)[-20:]
        )
        assert np.all(p > 0.7 * N), p.min()

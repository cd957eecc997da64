"""PCPS acquisition tests: planted satellites found, absent ones rejected,
and the acquisition -> tracking handoff converges."""

import numpy as np
import jax.numpy as jnp

from gpuacceleratedtracking_tpu.acquire import acquire, to_track_states
from gpuacceleratedtracking_tpu.models import GPSL1, gen_signal_mixed, soa
from gpuacceleratedtracking_tpu.tracking import TrackConfig, track_bank


def _scenario(N=4096, key=None, noise_std=0.0):
    system = GPSL1()
    prns = np.array([2, 9, 17])
    dops = np.array([1250.0, -2400.0, 300.0])
    phases = np.array([100.25, 511.0, 900.5])
    sig, fs = gen_signal_mixed(
        system, prns, dops, N, start_code_phases=phases,
        noise_std=noise_std, key=key,
    )
    return system, prns, dops, phases, sig, fs


def _check_against_f64(system, sig, prns, fs, max_doppler, got):
    """Float64 np.fft PCPS on ``sig [R, N]``: same grid, same decisions."""
    from gpuacceleratedtracking_tpu.bench import oracle

    rounds, n = sig.shape
    step = 2.0 / (3.0 * n / fs)
    dopplers = np.linspace(-max_doppler, max_doppler,
                           int(2 * max_doppler / step) + 1)
    idx = oracle.chip_index(system.code_frequency, fs, 0.0, np.arange(n),
                            system.code_length)
    code_fft = np.fft.fft(system.codes[idx][:, prns].T.astype(np.float64))
    t = np.arange(n) / fs
    power = np.stack([
        (np.abs(np.fft.ifft(
            np.fft.fft(sig * np.exp(-2j * np.pi * d * t))[:, None, :]
            * np.conj(code_fft)[None])) ** 2).sum(axis=0)
        for d in dopplers
    ])                                                  # [D, K, N]
    flat = power.transpose(1, 0, 2).reshape(len(prns), -1)
    best = flat.argmax(axis=1)
    np.testing.assert_allclose(np.asarray(got.carrier_doppler),
                               dopplers[best // n], rtol=1e-6)
    shift = (best % n) * system.code_frequency / fs % system.code_length
    want_phase = (system.code_length - shift) % system.code_length
    np.testing.assert_allclose(np.asarray(got.code_phase), want_phase,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.power), flat.max(axis=1),
                               rtol=1e-4)


class TestPCPS:
    def test_finds_planted_satellites(self):
        system, prns, dops, phases, sig, fs = _scenario()
        sre, sim = soa(sig)
        res = acquire(system, sre, sim, prns, fs, max_doppler=4000.0)
        got_dop = np.asarray(res.carrier_doppler)
        got_phase = np.asarray(res.code_phase)
        # Doppler within one bin (step = 2/(3 ms) ~ 667 Hz -> +/- 334 Hz).
        assert np.all(np.abs(got_dop - dops) < 400.0), got_dop
        # Code phase within one sample (~0.25 chips at 4.096 MHz).
        err = np.abs(got_phase - phases)
        err = np.minimum(err, system.code_length - err)
        assert np.all(err < 0.3), got_phase
        assert np.all(np.asarray(res.peak_metric) > 10.0)

    def test_matmul_dft_mode_matches_fft(self):
        # PCPS through jnp.fft against a float64 np.fft oracle: the same
        # Doppler bin and code-phase cell, and the peak power to f32
        # tolerance. Noise on: exercises real floors.
        import jax

        system, prns, dops, phases, sig, fs = _scenario(
            key=jax.random.key(7), noise_std=1.5)
        sre, sim = soa(sig)
        got = acquire(system, sre, sim, prns, fs, max_doppler=4000.0)
        _check_against_f64(system, np.asarray(sig)[None], prns, fs, 4000.0,
                           got)

    def test_matmul_dft_noncoherent_rounds(self):
        # Rounds axis: per-round powers summed, against the f64 oracle.
        import jax

        system = GPSL1()
        prns = np.array([5, 22])
        N, R = 2048, 4
        sig, fs = gen_signal_mixed(
            system, prns, np.array([950.0, -1800.0]), N * R,
            duration=R * 1e-3, start_code_phases=np.array([300.0, 77.0]),
            noise_std=2.0, key=jax.random.key(11),
        )
        sre, sim = soa(sig)
        got = acquire(system, sre.reshape(R, N), sim.reshape(R, N), prns, fs,
                      max_doppler=2000.0)
        _check_against_f64(system, np.asarray(sig).reshape(R, N), prns, fs,
                           2000.0, got)

    def test_rejects_absent_prn(self):
        system, prns, dops, phases, sig, fs = _scenario()
        sre, sim = soa(sig)
        res = acquire(system, sre, sim, np.array([2, 30]), fs,
                      max_doppler=4000.0)
        metrics = np.asarray(res.peak_metric)
        assert metrics[0] > 10.0          # present
        assert metrics[1] < 0.5 * metrics[0]  # absent: far weaker peak

    def test_with_noise(self):
        import jax

        system, prns, dops, phases, sig, fs = _scenario(
            key=jax.random.key(3), noise_std=2.0)
        sre, sim = soa(sig)
        res = acquire(system, sre, sim, prns, fs, max_doppler=4000.0)
        assert np.all(np.abs(np.asarray(res.carrier_doppler) - dops) < 400.0)
        assert np.all(np.asarray(res.peak_metric) > 2.5)

    def test_noncoherent_integration_beats_one_round(self):
        import jax

        system = GPSL1()
        prns = np.array([5])
        dops = np.array([950.0])
        N, R = 2046, 8
        sig, fs = gen_signal_mixed(
            system, prns, dops, N * R, duration=R * 1e-3,
            start_code_phases=np.array([300.0]),
            noise_std=6.0, key=jax.random.key(11),
        )
        sre, sim = soa(sig)
        one = acquire(system, sre[:N], sim[:N], prns, fs, max_doppler=2000.0)
        multi = acquire(system, sre.reshape(R, N), sim.reshape(R, N), prns,
                        fs, max_doppler=2000.0)
        # Noncoherent rounds raise the detection metric and nail the Doppler.
        assert float(multi.peak_metric[0]) > float(one.peak_metric[0])
        assert abs(float(multi.carrier_doppler[0]) - 950.0) < 400.0

    def test_handoff_to_tracking_converges(self):
        system, prns, dops, phases, sig0, fs = _scenario()
        sre0, sim0 = soa(sig0)
        res = acquire(system, sre0, sim0, prns, fs, max_doppler=4000.0,
                      doppler_step=250.0)
        states = to_track_states(res)

        N = sre0.shape[-1]
        B = 400
        sig, _ = gen_signal_mixed(
            system, prns, dops, N * B, duration=B * 1e-3,
            start_code_phases=phases,
        )
        sre, sim = soa(sig)
        config = TrackConfig.for_system(system, fs, N, algorithm="xla_bank")
        _, out = track_bank(
            config, jnp.asarray(system.codes), states,
            sre.reshape(B, N), sim.reshape(B, N),
        )
        dop = np.asarray(out.carrier_doppler)[-1]
        assert np.all(np.abs(dop - dops) < 20.0), dop
        assert np.all(np.asarray(out.cn0_dbhz)[-1] > 50.0)

"""Distributed-layer tests on the 8-device virtual CPU mesh.

The reference has no distributed tests (SURVEY.md §4); these follow the JAX
standard practice it never needed: `xla_force_host_platform_device_count=8`
(set in conftest) + mesh-sharded unit tests asserting bit-level agreement with
the single-device oracle.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuacceleratedtracking_tpu.models import (
    GPSL1,
    EPLCorrelator,
    correlator_sample_shifts,
    gen_signal,
    get_system,
    soa,
)
from gpuacceleratedtracking_tpu.ops import registry
from gpuacceleratedtracking_tpu import parallel
from gpuacceleratedtracking_tpu.tracking import (
    loop_filter,
    TrackConfig,
    init_state,
    track_bank,
)
from gpuacceleratedtracking_tpu.parallel import (
    channel_time_mesh,
    correlate_sharded,
    make_mesh,
    track_bank_sharded,
)


def _oracle(system, signal, fs, shifts, **kw):
    sre, sim = soa(signal)
    are, aim = registry.get("fused_xla")(
        sre, sim, jnp.asarray(system.codes), kw.get("prn", 0),
        kw.get("fcar", 1500.0), fs, kw.get("phicar", 0.0),
        system.code_frequency, kw.get("phicode", 0.0),
        tuple(int(s) for s in shifts), system.code_length,
    )
    return np.asarray(are) + 1j * np.asarray(aim)


class TestCorrelateSharded:
    @pytest.mark.parametrize("num_time", [2, 4, 8])
    def test_time_sharded_matches_oracle(self, num_time):
        system = GPSL1()
        N = 4096
        kw = dict(prn=5, fcar=-2345.0, phicar=0.9, phicode=517.3)
        signal, fs = gen_signal(
            system, kw["prn"], kw["fcar"], N,
            start_code_phase=kw["phicode"], start_carrier_phase=kw["phicar"],
        )
        shifts = tuple(int(s) for s in correlator_sample_shifts(
            system, EPLCorrelator(3), fs))
        mesh = make_mesh({"time": num_time})
        sre, sim = soa(signal)
        are, aim = jax.jit(functools.partial(
            correlate_sharded,
            sampling_frequency=fs,
            sample_shifts=shifts, code_length=system.code_length, mesh=mesh,
            nominal_code_frequency=system.code_frequency,
        ))(sre, sim, jnp.asarray(system.codes), kw["prn"], kw["fcar"],
           carrier_phase=kw["phicar"], code_frequency=system.code_frequency,
           code_phase=kw["phicode"])
        got = np.asarray(are) + 1j * np.asarray(aim)
        want = _oracle(system, signal, fs, shifts, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)

    def test_antenna_sharded_beamform(self):
        system = GPSL1()
        N = 2048
        signal, fs = gen_signal(system, 0, 1500.0, N, num_ants=4)
        shifts = tuple(int(s) for s in correlator_sample_shifts(
            system, EPLCorrelator(3), fs))
        mesh = make_mesh({"ant": 4, "time": 2})
        sre, sim = soa(signal)
        are, aim = jax.jit(functools.partial(
            correlate_sharded,
            sampling_frequency=fs,
            sample_shifts=shifts, code_length=system.code_length, mesh=mesh,
            nominal_code_frequency=system.code_frequency,
            ant_axis="ant", beamform=True,
        ))(sre, sim, jnp.asarray(system.codes), 0, 1500.0,
           carrier_phase=0.0, code_frequency=system.code_frequency,
           code_phase=0.0)
        want = _oracle(system, signal, fs, shifts).sum(axis=0)
        got = np.asarray(are) + 1j * np.asarray(aim)
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.1)

    def test_large_block_phase_advance_accuracy(self):
        # N = 2**17 (131 MHz-class block): the f64 nominal tables must keep the
        # sharded result on top of the single-device one.
        system = GPSL1()
        N = 2**17
        signal, fs = gen_signal(system, 2, 3210.0, N, start_code_phase=3.25)
        shifts = tuple(int(s) for s in correlator_sample_shifts(
            system, EPLCorrelator(3), fs))
        mesh = make_mesh({"time": 8})
        sre, sim = soa(signal)
        are, aim = jax.jit(functools.partial(
            correlate_sharded,
            sampling_frequency=fs,
            sample_shifts=shifts, code_length=system.code_length, mesh=mesh,
            nominal_code_frequency=system.code_frequency,
        ))(sre, sim, jnp.asarray(system.codes), 2, 3210.0,
           carrier_phase=0.0, code_frequency=system.code_frequency,
           code_phase=3.25)
        want = _oracle(system, signal, fs, shifts, prn=2, fcar=3210.0,
                       phicode=3.25)
        got = np.asarray(are) + 1j * np.asarray(aim)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=5.0)


class TestTrackBankSharded:
    def _scenario(self, num_k=4, num_ms=40, N=2048):
        system = GPSL1()
        fs = N / 1e-3
        dops = np.linspace(-2000.0, 2000.0, num_k)
        sigs = []
        for prn, d in enumerate(dops):
            scale = 1.0 + d / system.center_frequency
            s, _ = gen_signal(
                system, prn, d, N * num_ms, duration=num_ms * 1e-3,
                code_frequency=system.code_frequency * scale,
                start_code_phase=37.0 * prn,
            )
            sigs.append(s)
        mixed = sum(sigs[1:], sigs[0])
        sre, sim = soa(mixed)
        sre = sre.reshape(num_ms, N)
        sim = sim.reshape(num_ms, N)
        config = TrackConfig.for_system(system, fs, N)
        states = init_state(
            np.arange(num_k), carrier_doppler=dops,
            code_phase=37.0 * np.arange(num_k) % system.code_length,
        )
        return system, config, states, sre, sim

    def test_matches_unsharded_bank(self):
        system, config, states, sre, sim = self._scenario()
        mesh = channel_time_mesh(num_chan_shards=4, num_time_shards=2)
        final_s, out_s = track_bank_sharded(
            config, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        final_u, out_u = track_bank(
            config, jnp.asarray(system.codes), states, sre, sim
        )
        # psum ordering differs from the single-device sum; f32 rounding noise
        # is amplified through the loop transient, so compare at loop scale.
        np.testing.assert_allclose(
            np.asarray(out_s.carrier_doppler), np.asarray(out_u.carrier_doppler),
            rtol=1e-4, atol=0.5,
        )
        np.testing.assert_allclose(
            np.asarray(out_s.prompt_re), np.asarray(out_u.prompt_re),
            rtol=5e-3, atol=10.0,
        )
        np.testing.assert_allclose(
            np.asarray(final_s.code_phase), np.asarray(final_u.code_phase),
            rtol=1e-5, atol=1e-3,
        )

    @pytest.mark.parametrize("gnss,N", [
        ("GLONASSL1", 2048),       # 511-chip m-sequence, FDMA family
        ("GALILEOE1C", 8192),      # BOC(1,1) half-chip meander
        ("BEIDOUB1I", 8192),       # 2046-chip register codes (5th family)
    ])
    def test_all_families_shard(self, gnss, N):
        # Every constellation family must ride the channel mesh unchanged:
        # sharded-vs-unsharded parity of the closed loop per family (the
        # multichip path is family-agnostic by construction — this pins it).
        system = get_system(gnss)
        num_k, num_ms = 4, 30
        fs = N / 1e-3
        dops = np.linspace(-2000.0, 2000.0, num_k)
        sigs = []
        for prn, d in enumerate(dops):
            scale = 1.0 + d / system.center_frequency
            s, _ = gen_signal(
                system, prn, d, N * num_ms, duration=num_ms * 1e-3,
                code_frequency=system.code_frequency * scale,
                start_code_phase=37.0 * prn,
            )
            sigs.append(s)
        mixed = sum(sigs[1:], sigs[0])
        sre, sim = (np.asarray(x).reshape(num_ms, N) for x in soa(mixed))
        config = TrackConfig.for_system(system, fs, N, use_secondary=False)
        states = init_state(
            np.arange(num_k), carrier_doppler=dops,
            code_phase=37.0 * np.arange(num_k) % system.code_length,
        )
        mesh = channel_time_mesh(num_chan_shards=4, num_time_shards=2)
        sre, sim = jnp.asarray(sre), jnp.asarray(sim)
        final_s, out_s = track_bank_sharded(
            config, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        final_u, out_u = track_bank(
            config, jnp.asarray(system.codes), states, sre, sim
        )
        np.testing.assert_allclose(
            np.asarray(out_s.carrier_doppler),
            np.asarray(out_u.carrier_doppler), rtol=1e-4, atol=0.5,
        )
        np.testing.assert_allclose(
            np.asarray(out_s.prompt_re), np.asarray(out_u.prompt_re),
            rtol=5e-3, atol=10.0,
        )
        np.testing.assert_allclose(
            np.asarray(final_s.code_phase), np.asarray(final_u.code_phase),
            rtol=1e-5, atol=1e-3,
        )

    def test_converges_sharded(self):
        system, config, states, sre, sim = self._scenario(num_k=2, num_ms=120)
        mesh = channel_time_mesh(num_chan_shards=2, num_time_shards=4)
        final, out = track_bank_sharded(
            config, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        prompts = np.asarray(out.prompt_re)[-1]
        assert (prompts > 1500).all(), prompts

    def test_bank_kernel_algorithm_sharded(self, bank_algorithm):
        # Bank correlator inside the (chan, time) mesh: one bank correlation
        # per (shard, block) for all local channels, against the vmapped
        # per-channel path on the same mesh.
        system, config, states, sre, sim = self._scenario(num_k=4, num_ms=20)
        config_bank = dataclasses.replace(config, algorithm=bank_algorithm)
        config = dataclasses.replace(config, algorithm="fused_xla")
        mesh = channel_time_mesh(num_chan_shards=2, num_time_shards=2)
        final_b, out_b = track_bank_sharded(
            config_bank, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        final_x, out_x = track_bank_sharded(
            config, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        np.testing.assert_allclose(
            np.asarray(out_b.prompt_re), np.asarray(out_x.prompt_re),
            rtol=5e-3, atol=10.0,
        )
        np.testing.assert_allclose(
            np.asarray(final_b.code_phase), np.asarray(final_x.code_phase),
            rtol=1e-4, atol=5e-3,
        )

    def test_rows_kernel_sharded(self, bank_algorithm):
        # A bank correlator on the (chan, time) mesh must reproduce its own
        # unsharded run at 8.192 MHz.
        system, config, states, sre, sim = self._scenario(
            num_k=4, num_ms=10, N=8192
        )
        config_rows = dataclasses.replace(config, algorithm=bank_algorithm)
        mesh = channel_time_mesh(num_chan_shards=2, num_time_shards=2)
        final_s, out_s = track_bank_sharded(
            config_rows, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        final_u, out_u = track_bank(
            config_rows, jnp.asarray(system.codes), states, sre, sim
        )
        np.testing.assert_allclose(
            np.asarray(out_s.prompt_re), np.asarray(out_u.prompt_re),
            rtol=5e-3, atol=10.0,
        )
        np.testing.assert_allclose(
            np.asarray(final_s.code_phase), np.asarray(final_u.code_phase),
            rtol=1e-4, atol=5e-3,
        )

    def test_k2048_eight_shard_stress(self):
        # Realistic-scale mesh story: K=2048 over 8 channel shards (per-shard
        # K=256 — the real pod geometry where 2 chips put the 1024-channel
        # 32.768 MHz bank inside real time). Channels are independent given a
        # shared front end, so an unsharded run of the first-8-channel subset
        # pins per-channel correctness at scale without a 2048-channel oracle.
        system = GPSL1()
        N = 8192
        fs = N / 1e-3
        num_k, num_ms = 2048, 2
        sig, _ = gen_signal(system, 0, 800.0, N * num_ms, duration=num_ms * 1e-3)
        sre, sim = soa(sig)
        sre = sre.reshape(num_ms, N)
        sim = sim.reshape(num_ms, N)
        config = TrackConfig.for_system(system, fs, N, algorithm="xla_bank")
        rng = np.random.default_rng(0)
        dops = rng.uniform(-4000.0, 4000.0, num_k)
        states = init_state(
            np.arange(num_k) % 32, carrier_doppler=dops,
            code_phase=rng.uniform(0, 1023, num_k),
        )
        mesh = channel_time_mesh(num_chan_shards=8, num_time_shards=1)
        final, out = track_bank_sharded(
            config, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        assert final.code_phase.shape == (num_k,)
        sub = jax.tree.map(lambda x: x[:8], states)
        final8, out8 = track_bank(
            config, jnp.asarray(system.codes), sub, sre, sim
        )
        np.testing.assert_allclose(
            np.asarray(out.prompt_re)[:, :8], np.asarray(out8.prompt_re),
            rtol=1e-5, atol=1e-2,
        )
        np.testing.assert_allclose(
            np.asarray(final.code_phase)[:8], np.asarray(final8.code_phase),
            rtol=0, atol=1e-4,
        )

    def test_dual_bank_sharded_matches_unsharded(self):
        # Multi-chip leg of the mixed L1+L5 claim: GPS L5 dual-component
        # banks shard over channels with zero hot-path communication; the
        # sharded run must reproduce the unsharded dual bank (pilot loop,
        # NH wipe-off, and nav-symbol data prompts).
        from gpuacceleratedtracking_tpu.models import GPSL5
        from gpuacceleratedtracking_tpu.parallel import track_bank_dual_sharded
        from gpuacceleratedtracking_tpu.tracking import (
            dual_config,
            track_bank_dual,
        )

        sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
        N, num_ms, K = 16384, 6, 4
        fs = N / 1e-3
        sig, _ = gen_signal(
            sys_i, 0, 700.0, N * num_ms, duration=num_ms * 1e-3,
            secondary_code=sys_i.secondary_code,
        )
        sre, sim = (x.reshape(num_ms, N) for x in soa(sig))
        cfg = dual_config(TrackConfig.for_system(
            sys_i, fs, N, algorithm="xla_bank", use_secondary=False,
        ))
        states = init_state(
            np.arange(K), carrier_doppler=np.linspace(-900.0, 900.0, K)
        )
        mesh = channel_time_mesh(num_chan_shards=4, num_time_shards=1)
        final_s, out_s = track_bank_dual_sharded(
            cfg, jnp.asarray(sys_i.codes), jnp.asarray(sys_q.codes),
            states, sre, sim, mesh=mesh,
        )
        final_u, out_u = track_bank_dual(
            cfg, jnp.asarray(sys_i.codes), jnp.asarray(sys_q.codes),
            states, sre, sim,
        )
        np.testing.assert_allclose(
            np.asarray(out_s.pilot.prompt_re),
            np.asarray(out_u.pilot.prompt_re), rtol=1e-5, atol=1e-2,
        )
        np.testing.assert_allclose(
            np.asarray(out_s.data_prompt_re),
            np.asarray(out_u.data_prompt_re), rtol=1e-5, atol=1e-2,
        )
        np.testing.assert_allclose(
            np.asarray(final_s.code_phase), np.asarray(final_u.code_phase),
            rtol=0, atol=1e-4,
        )

    def test_output_sharding_layout(self):
        system, config, states, sre, sim = self._scenario(num_k=8, num_ms=4)
        mesh = channel_time_mesh(num_chan_shards=4, num_time_shards=2)
        final, out = track_bank_sharded(
            config, jnp.asarray(system.codes), states, sre, sim, mesh=mesh
        )
        assert out.prompt_re.shape == (4, 8)
        assert final.code_phase.shape == (8,)


def test_make_mesh_validates_device_count():
    with pytest.raises(ValueError):
        parallel.make_mesh({"chan": 64})

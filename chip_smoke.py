#!/usr/bin/env python
"""Run the tracker's main path on one GPU, phase by phase, and check it.

    python chip_smoke.py           # phases 1-7 on one card
    python chip_smoke.py --four    # only the sharded dry run on four cards

Each phase prints one line; any failure raises and exits non-zero. The last
line of standard output is ``{"ok": true, "device": {"platform", "kind",
"count"}}``. Without a GPU it refuses to run and prints no result.

Phases: (1) device and card; (2) golden EPL through ``fused_xla`` and both
bank correlators; (3) the three flagship bank shapes against the float64
oracle, on what the timed ``track_bank`` run produced, plus prompt chip
indices; (4) closed loops: a 1024-channel L1 bank and a 16-channel L5 dual
bank; (5) streaming from an int8 capture through the native decoder; (6)
32-PRN PCPS acquisition; (7) the Triton bank kernel against the plain XLA
bank. Phases 3-5 run ``bank``, which on the GPU is ``triton_bank``.

The phase functions take their sizes as arguments, so the tests rehearse
each one on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile

import numpy as np

# (system, channels, samples per 1 ms block, antennas, taps)
SHAPES = {
    "L1 K=1024 N=2^15 M=1 L=3": ("GPSL1", 1024, 32768, 1, 3),
    "L1 K=1024 N=2^18 M=1 L=3": ("GPSL1", 1024, 262144, 1, 3),
    "L5 K=256 N=2^15 M=4 L=7": ("GPSL5", 256, 32768, 4, 7),
}
GOLDEN = np.array([1476.0, 2500.0, 1476.0])


class SmokeError(RuntimeError):
    """A phase's output is wrong."""


def check(ok, message: str) -> None:
    if not ok:
        raise SmokeError(message)


def _gt():
    import gpuacceleratedtracking_tpu as gt

    return gt


def _finite(tree, what: str) -> None:
    import jax

    for leaf in jax.tree.leaves(tree):
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            check(np.isfinite(arr).all(), f"{what}: non-finite values")


def golden(banks=("xla_bank", "triton_bank"), bank_channels: int = 3) -> str:
    """GPS L1 PRN 1, N=2500 at 2.5 MHz, 1500 Hz: EPL is [1476, 2500, 1476]
    through ``fused_xla`` and each bank algorithm."""
    import jax
    import jax.numpy as jnp

    gt = _gt()
    system = gt.models.GPSL1()
    signal, fs = gt.models.gen_signal(system, 0, 1500.0, 2500)
    sre, sim = gt.models.soa(signal)
    shifts = (-1, 0, 1)
    codes = jnp.asarray(system.codes)
    fused = jax.jit(functools.partial(
        gt.ops.correlate_fused, sample_shifts=shifts,
        code_length=system.code_length))
    are, _ = fused(sre, sim, codes, 0, 1500.0, fs, 0.0,
                   system.code_frequency, 0.0)
    k = bank_channels
    got = [np.asarray(are)[None]]
    for name in banks:
        bank = jax.jit(functools.partial(
            gt.ops.registry.get(name), sample_shifts=shifts,
            code_length=system.code_length, sampling_frequency=fs))
        bre, _ = bank(sre, sim, codes, jnp.zeros(k, jnp.int32),
                      jnp.full(k, 1500.0), carrier_phase=jnp.zeros(k),
                      code_frequency=jnp.full(k, system.code_frequency),
                      code_phase=jnp.zeros(k))
        got.append(np.asarray(bre))
    got = np.concatenate(got)
    dev = float(np.abs(got - GOLDEN).max())
    check(np.array_equal(np.rint(got), np.broadcast_to(GOLDEN, got.shape))
          and dev < 0.5, f"golden EPL {got.tolist()}")
    return (f"fused_xla and {', '.join(banks)} (K={k}) = {GOLDEN.tolist()}, "
            f"max dev {dev:.3g}")


def chip_indices(cases=(("GPSL1", 2500, 0.0), ("GPSL1", 10000, 17.0),
                        ("GPSL1", 32768, 0.0), ("GPSL1", 32768, 651.5),
                        ("GPSL1", 262144, 0.0), ("GPSL1", 262144, 17.0),
                        ("GPSL5", 32768, 0.0), ("GPSL5", 32768, 9337.5))
                 ) -> str:
    """Prompt chip indices of the bank equal the float64 oracle's at nominal
    chip rates (fs = N kHz, none a multiple of the chip rate)."""
    import jax
    import jax.numpy as jnp

    gt = _gt()
    from gpuacceleratedtracking_tpu.bench import oracle
    from gpuacceleratedtracking_tpu.ops.correlate import bank_chip_index

    for name, n, phi in cases:
        system = gt.models.get_system(name)
        fs = n / 1e-3
        fn = jax.jit(functools.partial(
            bank_chip_index, sampling_frequency=fs,
            code_length=system.code_length))
        got = np.asarray(fn(jnp.asarray([system.code_frequency], jnp.float32),
                            code_phase=jnp.asarray([phi], jnp.float32),
                            sample_index=jnp.arange(n, dtype=jnp.int32)))[0]
        want = oracle.chip_index(system.code_frequency, fs, phi, np.arange(n),
                                 system.code_length)
        bad = int((got != want).sum())
        check(bad == 0, f"{name} N={n} phi={phi}: {bad} prompt chips differ")
    return f"prompt chip indices identical in {len(cases)} cases"


def _bank_scene(system, num_k, num_samples, num_ants, blocks, seed,
                planted=4, noise_std=1.0):
    """Seeded signal ``[B, (A,) N]`` with ``planted`` satellites, and K
    channel states: planted PRNs first (near their truth), the rest random."""
    import jax

    gt = _gt()
    rng = np.random.default_rng(seed)
    num_prns = system.codes.shape[1]
    prns = rng.choice(num_prns, planted, replace=False)
    dops = rng.uniform(-3000.0, 3000.0, planted)
    phases = rng.uniform(0.0, system.code_length, planted)
    signal, fs = gt.models.gen_signal_mixed(
        system, prns, dops, num_samples * blocks,
        num_ants=num_ants if num_ants > 1 else None,
        duration=blocks * 1e-3, start_code_phases=phases,
        noise_std=noise_std, key=jax.random.key(seed))
    sre, sim = gt.models.soa(signal)
    if num_ants > 1:
        sre = sre.reshape(num_ants, blocks, num_samples).swapaxes(0, 1)
        sim = sim.reshape(num_ants, blocks, num_samples).swapaxes(0, 1)
    else:
        sre = sre.reshape(blocks, num_samples)
        sim = sim.reshape(blocks, num_samples)
    chan_prn = np.arange(num_k) % num_prns
    chan_dop = rng.uniform(-4000.0, 4000.0, num_k)
    chan_code = rng.uniform(0.0, system.code_length, num_k)
    locked = np.zeros(num_k, bool)
    for i, (p, d, c) in enumerate(zip(prns, dops, phases)):
        ks = np.arange(i, num_k, planted)
        chan_prn[ks] = p
        chan_dop[ks] = d + rng.uniform(-10.0, 10.0, ks.size)
        chan_code[ks] = np.mod(c + rng.uniform(-0.05, 0.05, ks.size),
                               system.code_length)
        locked[ks] = True
    states = gt.tracking.init_state(
        chan_prn, carrier_doppler=chan_dop, code_phase=chan_code,
        carrier_phase=rng.uniform(0.0, 2 * np.pi, num_k))
    return fs, sre, sim, states, locked


def bank_parity(system_name: str, num_k: int, num_samples: int,
                num_ants: int, num_taps: int, *, blocks: int = 2,
                channels: int = 16, algorithm: str = "bank",
                seed: int = 0) -> float:
    """Run ``track_bank`` and compare ``channels`` of its accumulators, in
    the first and last block, with the float64 oracle fed the NCO state each
    block started from. Returns the largest deviation over N."""
    import jax
    import jax.numpy as jnp

    gt = _gt()
    from gpuacceleratedtracking_tpu.bench import oracle

    system = gt.models.get_system(system_name)
    fs, sre, sim, states, _ = _bank_scene(
        system, num_k, num_samples, num_ants, blocks, seed)
    config = gt.tracking.TrackConfig.for_system(
        system, fs, num_samples, num_correlators=num_taps,
        algorithm=algorithm, use_secondary=False)
    _, out = jax.block_until_ready(gt.tracking.track_bank(
        config, jnp.asarray(system.codes), states, sre, sim))
    _finite(out, system_name)
    pick = np.random.default_rng(seed + 1).choice(num_k, min(channels, num_k),
                                                  replace=False)
    sig = np.asarray(sre) + 1j * np.asarray(sim)
    acc = np.asarray(out.accum_re) + 1j * np.asarray(out.accum_im)
    worst = 0.0
    for b in (0, blocks - 1):
        if b == 0:
            car_dop, car_ph = states.carrier_doppler, states.carrier_phase
            code_dop, code_ph = states.code_doppler, states.code_phase
        else:
            car_dop, car_ph = out.carrier_doppler[b - 1], out.carrier_phase[b - 1]
            code_dop, code_ph = out.code_doppler[b - 1], out.code_phase[b - 1]
        car_dop, car_ph, code_dop, code_ph = (
            np.asarray(x, np.float64) for x in (car_dop, car_ph, code_dop, code_ph))
        for k in pick:
            want = oracle.correlate(
                sig[b], system.codes, int(states.prn[k]),
                config.intermediate_frequency + np.float32(car_dop[k]), fs,
                car_ph[k],
                np.float32(config.code_frequency) + np.float32(code_dop[k]),
                code_ph[k], config.sample_shifts)
            worst = max(worst, float(np.abs(acc[b, k] - want).max()))
    check(worst <= 1e-3 * num_samples,
          f"{system_name} N={num_samples}: deviation {worst:.4g} > 1e-3 N")
    return worst / num_samples


def closed_loop_l1(num_k: int = 1024, num_samples: int = 32768,
                   blocks: int = 24, seed: int = 3,
                   algorithm: str = "bank") -> str:
    """K-channel L1 bank, closed loop: planted channels hold |prompt|."""
    import jax
    import jax.numpy as jnp

    gt = _gt()
    system = gt.models.GPSL1()
    fs, sre, sim, states, locked = _bank_scene(
        system, num_k, num_samples, 1, blocks, seed)
    config = gt.tracking.TrackConfig.for_system(
        system, fs, num_samples, algorithm=algorithm)
    final, out = jax.block_until_ready(gt.tracking.track_bank(
        config, jnp.asarray(system.codes), states, sre, sim))
    _finite((final, out), "L1 closed loop")
    mag = np.abs(np.asarray(out.prompt_re)[-1]
                 + 1j * np.asarray(out.prompt_im)[-1])
    low = float(mag[locked].min()) / num_samples
    check(low > 0.7, f"L1 closed loop: weakest planted |prompt|/N {low:.3f}")
    return (f"L1 K={num_k} N={num_samples} {blocks} blocks: "
            f"{int(locked.sum())} planted channels, min |prompt|/N {low:.3f}")


def closed_loop_l5_dual(num_k: int = 16, num_samples: int = 32768,
                        blocks: int = 30, seed: int = 5,
                        algorithm: str = "bank") -> str:
    """K-channel GPS L5 data+pilot bank, pilot-driven loop closure."""
    import jax
    import jax.numpy as jnp

    gt = _gt()
    sys_i, sys_q = gt.models.GPSL5(), gt.models.GPSL5(quadrature=True)
    fs = num_samples / 1e-3
    rng = np.random.default_rng(seed)
    prns = rng.choice(sys_i.codes.shape[1], 4, replace=False)
    dops = rng.uniform(-3000.0, 3000.0, 4)
    total = 0.0
    for p, d in zip(prns, dops):
        common = dict(duration=blocks * 1e-3,
                      code_frequency=sys_i.code_frequency
                      * (1 + d / sys_i.center_frequency))
        s_i, _ = gt.models.gen_signal(sys_i, int(p), float(d),
                                      num_samples * blocks,
                                      secondary_code=sys_i.secondary_code,
                                      **common)
        s_q, _ = gt.models.gen_signal(sys_q, int(p), float(d),
                                      num_samples * blocks,
                                      secondary_code=sys_q.secondary_code,
                                      start_carrier_phase=np.pi / 2, **common)
        total = total + s_i + s_q
    sre = jnp.real(total).reshape(blocks, num_samples)
    sim = jnp.imag(total).reshape(blocks, num_samples)
    ks = np.arange(num_k)
    states = gt.tracking.init_state(
        prns[ks % 4], carrier_doppler=dops[ks % 4] + rng.uniform(-5, 5, num_k))
    config = gt.tracking.dual_config(gt.tracking.TrackConfig.for_system(
        sys_i, fs, num_samples, algorithm=algorithm, use_secondary=False))
    final, out = jax.block_until_ready(gt.tracking.track_bank_dual(
        config, jnp.asarray(sys_i.codes), jnp.asarray(sys_q.codes),
        states, sre, sim))
    _finite((final, out), "L5 dual closed loop")
    mag = np.abs(np.asarray(out.pilot.prompt_re)[-1]
                 + 1j * np.asarray(out.pilot.prompt_im)[-1])
    low = float(mag.min()) / num_samples
    check(low > 0.7, f"L5 dual: weakest pilot |prompt|/N {low:.3f}")
    return (f"L5 dual K={num_k} N={num_samples} {blocks} blocks: "
            f"min pilot |prompt|/N {low:.3f}")


def stream(num_k: int = 64, num_samples: int = 32768, blocks: int = 40,
           seed: int = 7, algorithm: str = "bank") -> str:
    """StreamTracker over a seeded int8 capture through the native decoder."""
    gt = _gt()
    from gpuacceleratedtracking_tpu.runtime import iq, stream as stream_mod

    check(iq.native_available(), "native iqstream library did not load")
    system = gt.models.GPSL1()
    fs, sre, sim, states, locked = _bank_scene(
        system, num_k, num_samples, 1, blocks, seed, noise_std=0.5)
    scale = 20.0
    inter = np.empty(2 * sre.size, np.float32)
    inter[0::2] = np.asarray(sre).ravel() * scale
    inter[1::2] = np.asarray(sim).ravel() * scale
    config = gt.tracking.TrackConfig.for_system(
        system, fs, num_samples, algorithm=algorithm)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.int8")
        np.clip(np.rint(inter), -127, 127).astype(np.int8).tofile(path)
        tracker = stream_mod.StreamTracker(
            config, system.codes, states, blocks_per_dispatch=10)
        with iq.IQFile(path, "int8", 1.0 / scale) as f:
            result = tracker.run(stream_mod.blocks(f, num_samples))
    check(result.blocks_processed == blocks,
          f"stream processed {result.blocks_processed} of {blocks} blocks")
    out = result.stacked()
    _finite(out, "stream")
    mag = np.abs(out.prompt_re[-1] + 1j * out.prompt_im[-1])
    low = float(mag[locked].min()) / num_samples
    check(low > 0.7, f"stream: weakest planted |prompt|/N {low:.3f}")
    return (f"native int8 decode, K={num_k} N={num_samples} {blocks} blocks: "
            f"min planted |prompt|/N {low:.3f}")


def acquisition(num_samples: int = 32768, num_prns: int = 32,
                seed: int = 11) -> str:
    """PCPS over ``num_prns`` PRNs through `jnp.fft` finds the planted ones."""
    import jax

    gt = _gt()
    system = gt.models.GPSL1()
    rng = np.random.default_rng(seed)
    planted = rng.choice(num_prns, 4, replace=False)
    dops = rng.uniform(-4500.0, 4500.0, 4)
    phases = rng.uniform(0.0, system.code_length, 4)
    signal, fs = gt.models.gen_signal_mixed(
        system, planted, dops, num_samples, start_code_phases=phases,
        noise_std=1.0, key=jax.random.key(seed))
    sre, sim = gt.models.soa(signal)
    res = jax.block_until_ready(
        gt.acquire.acquire(system, sre, sim, np.arange(num_prns), fs))
    step = 2.0 / (3.0 * num_samples / fs)
    for p, d, c in zip(planted, dops, phases):
        metric = float(res.peak_metric[p])
        dop_err = abs(float(res.carrier_doppler[p]) - d)
        code_err = abs((float(res.code_phase[p]) - c + system.code_length / 2)
                       % system.code_length - system.code_length / 2)
        check(metric > 8.0 and dop_err <= step and code_err <= 1.0,
              f"PRN {p}: metric {metric:.1f}, Doppler error {dop_err:.0f} Hz, "
              f"code error {code_err:.2f} chips")
    return (f"{num_prns} PRNs at N={num_samples}: planted {sorted(planted.tolist())}"
            f" found, min metric {float(res.peak_metric[planted].min()):.1f}")


def triton_vs_plain(system_name: str, num_k: int, num_samples: int,
                    num_ants: int, num_taps: int, seed: int = 0,
                    interpret: bool = False) -> float:
    """The Triton bank kernel's output against the plain bank's, one block
    of random channels; returns the largest deviation over N."""
    import jax
    import jax.numpy as jnp

    gt = _gt()
    from gpuacceleratedtracking_tpu.ops.triton_bank import correlate_triton_bank

    system = gt.models.get_system(system_name)
    fs, sre, sim, states, _ = _bank_scene(
        system, num_k, num_samples, num_ants, 1, seed)
    shifts = gt.tracking.TrackConfig.for_system(
        system, fs, num_samples, num_correlators=num_taps).sample_shifts
    args = (sre[0], sim[0], jnp.asarray(system.codes), states.prn,
            states.carrier_doppler)
    kw = dict(carrier_phase=states.carrier_phase,
              code_frequency=system.code_frequency + states.code_doppler,
              code_phase=states.code_phase, sample_shifts=shifts,
              code_length=system.code_length, sampling_frequency=fs)
    plain = jax.jit(functools.partial(
        gt.ops.registry.get("xla_bank"), **kw))(*args)
    kern = correlate_triton_bank(*args, interpret=interpret, **kw)
    dev = max(float(jnp.abs(a - b).max()) for a, b in zip(plain, kern))
    check(dev <= 1e-3 * num_samples,
          f"triton_bank {system_name}: deviation {dev:.4g} > 1e-3 N")
    return dev / num_samples


def run_one_card() -> None:
    for name, shape in SHAPES.items():
        dev = bank_parity(*shape)
        print(f"phase 3 bank parity {name}: max |acc - f64 oracle|/N {dev:.3g}",
              flush=True)
    print(f"phase 3 chip indices: {chip_indices()}", flush=True)
    print(f"phase 4 closed loop: {closed_loop_l1()}", flush=True)
    print(f"phase 4 closed loop: {closed_loop_l5_dual()}", flush=True)
    print(f"phase 5 stream: {stream()}", flush=True)
    print(f"phase 6 acquisition: {acquisition()}", flush=True)
    for name, shape in SHAPES.items():
        dev = triton_vs_plain(*shape)
        print(f"phase 7 triton_bank {name}: max |kernel - plain|/N {dev:.3g}",
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded dry run on four cards")
    args = parser.parse_args(argv)

    from gpuacceleratedtracking_tpu import device

    device.enable_compile_cache()
    device.require_gpu()
    info = device.describe()
    print(f"phase 1 device: {info['kind']} x{info['count']}", flush=True)
    print(device.nvidia_smi(), flush=True)
    if args.four:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import __graft_entry__

        if info["count"] < 4:
            raise SmokeError(f"--four needs 4 cards, found {info['count']}")
        __graft_entry__.dryrun_multichip(4)
        print("phase 8 dryrun_multichip(4): sharded L1 bank and L5 dual bank "
              "match their unsharded runs", flush=True)
    else:
        print(f"phase 2 golden: {golden()}", flush=True)
        run_one_card()
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark harness: kernel / reduction / replica benchmarks, dict-driven.

Mirrors the reference's public harness surface (`run_kernel_benchmark`,
`run_reduction_benchmark`, `run_replica_benchmark`, `add_results!`,
`add_metadata!` — `/root/reference/src/benchmarks.jl:963-1147`,
`src/replica_benchmarks.jl:137-147`) with the same dict-config keys
(``processor / GNSS / num_samples / num_ants / num_correlators / algorithm``,
`/root/reference/scripts/run_benchmarks_gpsl1.jl:5-20`).

``processor`` selects the device the arrays live on: unset (the default
device, ``jax.devices()[0]``) or ``"CPU"`` (the XLA-CPU baseline, playing the
role of the reference's LoopVectorization SIMD path,
`/root/reference/src/benchmarks.jl:35-80`). Every result records the device's
``platform``, ``device_kind`` and the device count.
"""

from __future__ import annotations

import functools
import platform
import subprocess
from typing import Optional

import jax
import jax.numpy as jnp

from ..models import EPLCorrelator, correlator_sample_shifts, gen_signal, get_system, soa
from ..ops import registry, replica as replica_ops
from ..ops.reduce import get_reduction
from .timing import TrialStats, benchmark, benchmark_differential, benchmark_pipelined

REALTIME_BOUND_S = 1e-3  # process 1 ms of signal in under 1 ms (paper.tex:345)


def _git_sha() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=str(__import__("pathlib").Path(__file__).parent),
        ).stdout.strip() or None
    except Exception:
        return None


def add_metadata(results: dict, device, algorithm: str) -> dict:
    """Environment metadata — the `add_metadata!` analog
    (`/root/reference/src/benchmarks.jl:11-32`). ``device`` is the one the
    benchmark's arrays lived on."""
    results.update(
        {
            "os": platform.platform(),
            "cpu_model": platform.processor() or platform.machine(),
            "backend": jax.default_backend(),
            "platform": device.platform,
            "device_kind": device.device_kind,
            "device_count": len(jax.devices(device.platform)),
            "jax_version": jax.__version__,
            "processor": device.platform.upper(),
            "algorithm": algorithm,
            "git_sha": _git_sha(),
        }
    )
    return results


def _resolve_device(processor: Optional[str]):
    if processor is not None and processor.upper() == "CPU":
        return jax.local_devices(backend="cpu")[0]
    return jax.devices()[0]


def run_kernel_benchmark(config: dict) -> dict:
    """Benchmark one correlator algorithm for one scenario dict.

    Keys: ``GNSS`` ("GPSL1"/"GPSL5"), ``num_samples``, ``num_ants``,
    ``num_correlators``, ``algorithm`` (registry name), ``processor``
    (unset or "CPU"), optional ``reps``/``trials``.
    """
    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    num_ants = int(config.get("num_ants", 1))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "fused_xla")
    processor = config.get("processor")
    reps = config.get("reps", 20)
    if reps == "auto":
        # Scale the unroll depth inversely with N so each timed call does
        # >= ~1-2 ms of device work; capped at 128 to bound the compile cost
        # of the unrolled 2x-depth twin.
        reps = int(min(128, max(8, (1 << 22) // num_samples)))
    reps = int(reps)
    trials = int(config.get("trials", 7))
    reps_mode = config.get("reps_mode", "unroll")

    fs = num_samples / 1e-3
    shifts = tuple(
        int(s)
        for s in correlator_sample_shifts(
            system, EPLCorrelator(num_correlators), fs
        )
    )
    signal, _ = gen_signal(system, 0, 1500.0, num_samples, num_ants=num_ants)
    sre, sim = soa(signal)
    device = _resolve_device(processor)
    sre, sim = jax.device_put(sre, device), jax.device_put(sim, device)
    codes = jax.device_put(jnp.asarray(system.codes), device)

    corr = functools.partial(
        registry.get(algorithm),
        sample_shifts=shifts,
        code_length=system.code_length,
    )
    is_bank = algorithm in registry.BANK_ALGORITHMS

    # reps run inside one jitted call and are timed differentially so the
    # fixed per-dispatch cost cancels (see benchmark_differential).
    def make_fn(r):
        if is_bank:
            # Bank-signature algorithms take [K] channel-parameter arrays and
            # a shared front-end signal; benchmark them at K=1 so the kernel
            # sweep covers every registry algorithm on equal terms.
            prn1 = jax.device_put(jnp.zeros((1,), jnp.int32), device)
            fcar1 = jax.device_put(jnp.full((1,), 1500.0, jnp.float32), device)
            fcode1 = jax.device_put(
                jnp.full((1,), system.code_frequency, jnp.float32), device
            )

            def call(off):
                return corr(sre, sim, codes, prn1, fcar1, fs, off[None],
                            fcode1, off[None])
        else:
            def call(off):
                return corr(
                    sre, sim, codes, 0, 1500.0, fs, off,
                    system.code_frequency, off,
                )

        if reps_mode == "scan":
            # Scan-carried reps: constant compile cost at any depth.
            @jax.jit
            def run(offs):
                def body(total, off):
                    are, aim = call(off)
                    return total + are.sum() + aim.sum(), None

                return jax.lax.scan(
                    body, jnp.float32(0.0), offs, unroll=4
                )[0]
        else:
            @jax.jit
            def run(offs):
                total = jnp.float32(0.0)
                for i in range(r):
                    are, aim = call(offs[i])
                    total = total + are.sum() + aim.sum()
                return total

        offs = jax.device_put(
            jnp.linspace(0.0, 0.1, r).astype(jnp.float32), device
        )
        return run, (offs,)

    stats = benchmark_differential(make_fn, reps, trials=trials)

    results = dict(config)
    results.update(stats.to_dict())
    results["reps_resolved"] = reps
    results["reps_mode"] = reps_mode
    # Derived metrics use the MEDIAN: the differential minimum can clamp to
    # ~0 under timing noise, which explodes the derived rates.
    floor = max(stats.median, 1e-9)
    results["realtime_ratio"] = floor / REALTIME_BOUND_S
    results["samples_per_s"] = num_samples * num_ants / floor
    return add_metadata(results, device, algorithm)


def run_track_benchmark(config: dict) -> dict:
    """Benchmark the CLOSED tracking loop: per-block correlate + DLL/PLL/FLL.

    The reference exports `run_track_benchmark` but never defines it
    (`/root/reference/src/GPUAcceleratedTracking.jl:102` — a dead export);
    this framework provides the working equivalent. One timed unit is a full
    1 ms epoch of a K-channel bank: bank correlation, discriminators, loop
    filters and NCO state advance, all inside one `lax.scan` on device.

    Keys: ``GNSS``, ``num_samples`` (per block), ``num_channels``,
    ``num_ants``, ``num_correlators``, ``algorithm`` (bank algorithms run one
    bank correlation per block), ``processor``, optional ``blocks``/``trials``.
    Timing is differential over scan length (B vs 2B blocks) so fixed
    dispatch cost cancels; reported times are per block.
    """
    import numpy as np

    from ..tracking import TrackConfig, init_state, track_bank

    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    num_channels = int(config.get("num_channels", 1))
    num_ants = int(config.get("num_ants", 1))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "xla_bank")
    processor = config.get("processor")
    blocks = int(config.get("blocks", 8))
    trials = int(config.get("trials", 7))

    fs = num_samples / 1e-3
    device = _resolve_device(processor)
    cfg = TrackConfig.for_system(
        system, fs, num_samples, num_correlators=num_correlators,
        algorithm=algorithm,
    )
    prns = np.arange(num_channels) % system.codes.shape[1]
    dops = np.linspace(-4000.0, 4000.0, num_channels)
    states = jax.device_put(init_state(prns, carrier_doppler=dops), device)
    codes = jax.device_put(jnp.asarray(system.codes), device)

    def make_fn(b):
        signal, _ = gen_signal(
            system, 0, 1500.0, num_samples * b, num_ants=num_ants,
            duration=b * 1e-3,
        )
        sre, sim = soa(signal)
        if num_ants > 1:
            sre = sre.reshape(num_ants, b, num_samples).swapaxes(0, 1)
            sim = sim.reshape(num_ants, b, num_samples).swapaxes(0, 1)
        else:
            sre = sre.reshape(b, num_samples)
            sim = sim.reshape(b, num_samples)
        sre = jax.device_put(sre, device)
        sim = jax.device_put(sim, device)

        def run():
            return track_bank(cfg, codes, states, sre, sim)

        return run, ()

    stats = benchmark_differential(make_fn, blocks, trials=trials)
    results = dict(config)
    results.update(stats.to_dict())
    floor = max(stats.median, 1e-9)   # median: differential min can clamp ~0
    results["realtime_ratio"] = floor / REALTIME_BOUND_S
    results["samples_per_s"] = num_channels * num_samples * num_ants / floor
    results["realtime_channels"] = num_channels * REALTIME_BOUND_S / floor
    return add_metadata(results, device, algorithm)


def run_dual_track_benchmark(config: dict) -> dict:
    """Benchmark the CLOSED dual-component (data+pilot) L5 tracking loop.

    The north-star capability (BASELINE.md: "GPS L1+L5 channels tracked in
    real time"): K dual channels run as ONE 2K-channel bank correlation per
    block (`tracking.dual.track_bank_dual` — I5 data + Q5 pilot columns),
    with NH10/NH20 overlay wipe-off and pilot-driven atan2 loop closure live
    in the timed path. The reference feeds its GPSL5 system into open-loop
    kernels only (`/root/reference/scripts/run_benchmarks_gpsl5.jl`; closed
    loops live in its external Tracking.jl fork and are never GPU-timed).

    Keys as `run_track_benchmark`; ``num_channels`` counts DUAL channels
    (``bank_channels = 2 K`` correlation channels). ``realtime_channels`` is
    dual channels per chip.
    """
    import numpy as np

    from ..models import GPSL5
    from ..tracking import TrackConfig, dual_config, init_state, track_bank_dual

    num_samples = int(config["num_samples"])
    num_channels = int(config.get("num_channels", 1))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "xla_bank")
    processor = config.get("processor")
    blocks = int(config.get("blocks", 8))
    trials = int(config.get("trials", 7))

    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    fs = num_samples / 1e-3
    device = _resolve_device(processor)
    cfg = dual_config(TrackConfig.for_system(
        sys_i, fs, num_samples, num_correlators=num_correlators,
        algorithm=algorithm, use_secondary=False,
    ))
    num_prns = sys_i.codes.shape[1]
    prns = np.arange(num_channels) % num_prns
    dops = np.linspace(-4000.0, 4000.0, num_channels)
    states = jax.device_put(init_state(prns, carrier_doppler=dops), device)
    codes_i = jax.device_put(jnp.asarray(sys_i.codes), device)
    codes_q = jax.device_put(jnp.asarray(sys_q.codes), device)

    def make_fn(b):
        signal, _ = gen_signal(
            sys_i, 0, 1500.0, num_samples * b, duration=b * 1e-3,
            secondary_code=sys_i.secondary_code,
        )
        sre, sim = soa(signal)
        sre = jax.device_put(sre.reshape(b, num_samples), device)
        sim = jax.device_put(sim.reshape(b, num_samples), device)

        def run():
            return track_bank_dual(cfg, codes_i, codes_q, states, sre, sim)

        return run, ()

    stats = benchmark_differential(make_fn, blocks, trials=trials)
    results = dict(config)
    results.update(stats.to_dict())
    floor = max(stats.median, 1e-9)
    results["bank_channels"] = 2 * num_channels
    results["realtime_ratio"] = floor / REALTIME_BOUND_S
    results["samples_per_s"] = 2 * num_channels * num_samples / floor
    results["realtime_channels"] = num_channels * REALTIME_BOUND_S / floor
    return add_metadata(results, device, algorithm)


def run_acquire_benchmark(config: dict) -> dict:
    """Benchmark PCPS acquisition: circular correlation over a Doppler grid,
    K PRNs searched at once, noncoherent round summation, through `jnp.fft`
    on the chosen device. Role match: Acquisition.jl feeding Tracking.jl
    in the reference ecosystem (`/root/reference/src/benchmarks.jl:54`).

    Keys: ``GNSS``, ``num_samples``, ``num_prns``, optional ``processor``,
    ``rounds`` (noncoherent), ``max_doppler``/``doppler_step``, ``trials``.
    Reported unit: one full acquisition call (all PRNs x all bins x rounds).
    """
    import numpy as np

    from ..acquire import acquire

    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    num_prns = int(config.get("num_prns", 8))
    rounds = int(config.get("rounds", 1))
    trials = int(config.get("trials", 7))
    processor = config.get("processor")
    max_doppler = float(config.get("max_doppler", 5000.0))
    fs = num_samples / 1e-3
    t = num_samples / fs
    doppler_step = float(config.get("doppler_step", 2.0 / (3.0 * t)))
    num_bins = int(2 * max_doppler / doppler_step) + 1

    device = _resolve_device(processor)
    signal, _ = gen_signal(
        system, 0, 1200.0, num_samples * rounds, duration=rounds * 1e-3
    )
    sre, sim = soa(signal)
    if rounds > 1:
        sre = sre.reshape(rounds, num_samples)
        sim = sim.reshape(rounds, num_samples)
    sre = jax.device_put(sre, device)
    sim = jax.device_put(sim, device)
    prns = np.arange(num_prns) % system.codes.shape[1]

    def run():
        return acquire(
            system, sre, sim, prns, fs, max_doppler=max_doppler,
            doppler_step=doppler_step,
        )

    stats = benchmark(run, trials=trials)
    results = dict(config)
    results.update(stats.to_dict())
    results["num_bins"] = num_bins
    results["rounds"] = rounds
    results["num_prns"] = num_prns
    return add_metadata(results, device, "pcps")


def run_reduction_benchmark(config: dict) -> dict:
    """Benchmark a reduction fusion degree over ``[N, A, L]`` product planes.

    Keys: ``num_samples``, ``num_ants``, ``num_correlators``,
    ``algorithm`` ("pure"/"cplx"/"cplx_multi"), ``processor``.
    Mirrors `/root/reference/src/benchmarks.jl:981-1135`.
    """
    num_samples = int(config["num_samples"])
    num_ants = int(config.get("num_ants", 4))
    num_correlators = int(config.get("num_correlators", 3))
    algorithm = config.get("algorithm", "cplx_multi")
    processor = config.get("processor")
    reps = config.get("reps", 20)
    if reps == "auto":
        # >= ~2 ms of device work per timed call: scan-carried reps are
        # compile-free, so scale deep and inversely with N.
        reps = int(min(8192, max(256, (1 << 24) // num_samples)))
    reps = int(reps)
    trials = int(config.get("trials", 7))

    red = get_reduction(algorithm)
    device = _resolve_device(processor)
    shape = (num_samples, num_ants, num_correlators)
    key = jax.random.key(0)
    prod_re = jax.device_put(jax.random.normal(key, shape, jnp.float32), device)
    prod_im = jax.device_put(
        jax.random.normal(jax.random.key(1), shape, jnp.float32), device
    )

    # reps ride a `lax.scan` (unroll=32 amortizes loop bookkeeping), not a
    # Python unroll: these kernels are O(µs), so thousands of reps per timed
    # call keep compile cost constant.
    def make_fn(r):
        @jax.jit
        def run(scales):
            def body(total, s):
                are, aim = red(prod_re * s, prod_im * s)
                return total + are.sum() + aim.sum(), None

            total, _ = jax.lax.scan(
                body, jnp.float32(0.0), scales, unroll=32
            )
            return total

        scales = jax.device_put(
            jnp.linspace(1.0, 1.01, r).astype(jnp.float32), device
        )
        return run, (scales,)

    stats = benchmark_differential(make_fn, reps, trials=trials)
    results = dict(config)
    results.update(stats.to_dict())
    return add_metadata(results, device, algorithm)


def run_replica_benchmark(config: dict) -> dict:
    """Benchmark code-replica generation: exact vs quantized-NCO lookup.

    The gmem-vs-texture replica benchmark analog
    (`/root/reference/src/replica_benchmarks.jl:1-147`): ``algorithm`` is
    ``"exact"`` (integer floor/mod arithmetic — the global-memory path) or
    ``"quantized"`` (fixed-point NCO — the texture-interpolant path).
    """
    system = get_system(config["GNSS"])
    num_samples = int(config["num_samples"])
    algorithm = config.get("algorithm", "exact")
    processor = config.get("processor")
    reps = config.get("reps", 20)
    if reps == "auto":
        # See run_reduction_benchmark: deep scan-carried reps for small N.
        reps = int(min(4096, max(32, (1 << 23) // num_samples)))
    reps = int(reps)
    trials = int(config.get("trials", 7))
    fs = num_samples / 1e-3

    gen = (
        replica_ops.gen_code_replica
        if algorithm == "exact"
        else replica_ops.gen_code_replica_quantized
    )
    device = _resolve_device(processor)
    codes = jax.device_put(jnp.asarray(system.codes), device)

    # Scan-carried reps (see run_reduction_benchmark): constant compile cost
    # at any depth.
    def make_fn(r):
        @jax.jit
        def run(phases):
            def body(total, phase):
                rep = gen(
                    codes, 0, system.code_frequency, fs, phase,
                    num_samples, -1, 1, system.code_length,
                )
                return total + rep.sum(), None

            total, _ = jax.lax.scan(
                body, jnp.float32(0.0), phases, unroll=32
            )
            return total

        phases = jax.device_put(
            jnp.linspace(0.0, 0.5, r).astype(jnp.float32), device
        )
        return run, (phases,)

    stats = benchmark_differential(make_fn, reps, trials=trials)
    results = dict(config)
    results.update(stats.to_dict())
    return add_metadata(results, device, algorithm)

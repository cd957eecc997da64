#!/usr/bin/env python
"""Headline benchmark: aggregate EPL bank-correlator throughput on one card.

The default correlator is ``bank``, which on the GPU is the Pallas Triton
bank kernel; ``BENCH_ALGO=xla_bank`` times the plain XLA bank.

Prints the card (``nvidia-smi`` name and power limit), then ONE JSON line
``{"metric", "value", "unit", "vs_baseline", ...}`` with the device's
``platform``, ``device_kind`` and count. Refuses to run without a GPU.

Protocol: differential median (`bench.timing.benchmark_differential`): the
per-block time is ``(t(2r) - t(r)) / r`` over paired jits that run ``r`` and
``2r`` distinct bank blocks, which cancels the fixed dispatch cost; the median
over trials is the headline and the minimum (burst) is also reported. This
mirrors the reference's BenchmarkTools protocol under ``CUDA.@sync``
(`/root/reference/paper/paper.tex:147-150`).

Baseline: the reference's best single-channel real-time figure, ~100 MHz
(1e8 samples/s) EPL on a GTX 1050 Ti (`/root/reference/paper/paper.tex:345`);
``vs_baseline`` is this card's aggregate throughput over that bound. The
default cell is a 1024-channel GPS L1 bank at 262.144 MHz (N = 2^18), the top
of the reference's own envelope (`/root/reference/scripts/
run_benchmarks_gpsl1.jl:8`). ``BENCH_CHANNELS``, ``BENCH_SAMPLES``,
``BENCH_ALGO`` (a bank algorithm of `ops.registry`), ``BENCH_REPS`` and
``BENCH_TRIALS`` override it.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp

NUM_CHANNELS = int(os.environ.get("BENCH_CHANNELS", "1024"))
NUM_SAMPLES = int(os.environ.get("BENCH_SAMPLES", "262144"))
REPS = int(os.environ.get("BENCH_REPS", "4"))
TRIALS = int(os.environ.get("BENCH_TRIALS", "9"))
ALGORITHM = os.environ.get("BENCH_ALGO", "bank")
BASELINE_SAMPLES_PER_S = 1e8


def main():
    from gpuacceleratedtracking_tpu import device
    from gpuacceleratedtracking_tpu.bench.timing import benchmark_differential
    from gpuacceleratedtracking_tpu.models import (
        GPSL1,
        EPLCorrelator,
        correlator_sample_shifts,
        gen_signal,
        soa,
    )
    from gpuacceleratedtracking_tpu.ops import registry

    device.enable_compile_cache()
    device.require_gpu()
    print(device.nvidia_smi(), flush=True)
    system = GPSL1()
    fs = NUM_SAMPLES / 1e-3
    signal, _ = gen_signal(system, 0, 1500.0, NUM_SAMPLES)
    sre, sim = soa(signal)
    codes = jnp.asarray(system.codes)
    shifts = tuple(
        int(s)
        for s in correlator_sample_shifts(system, EPLCorrelator(3), fs)
    )
    prns = jnp.arange(NUM_CHANNELS, dtype=jnp.int32) % codes.shape[1]
    dopplers = jnp.linspace(-4000.0, 4000.0, NUM_CHANNELS).astype(jnp.float32)
    code_freqs = jnp.full((NUM_CHANNELS,), system.code_frequency, jnp.float32)
    zeros = jnp.zeros(NUM_CHANNELS, jnp.float32)
    corr = functools.partial(
        registry.get(ALGORITHM), sample_shifts=shifts,
        code_length=system.code_length, sampling_frequency=fs,
    )

    def make(r):
        """One jitted call executing ``r`` distinct bank blocks."""

        @jax.jit
        def run(offs):
            tot = jnp.float32(0.0)
            for i in range(r):
                are, aim = corr(
                    sre, sim, codes, prns, 1500.0 + dopplers,
                    carrier_phase=zeros + offs[i], code_frequency=code_freqs,
                    code_phase=zeros,
                )
                tot = tot + are.sum() + aim.sum()
            return tot

        return run, (jnp.linspace(0.0, 0.1, r).astype(jnp.float32),)

    stats = benchmark_differential(make, REPS, trials=TRIALS)
    median = max(stats.median, 1e-9)   # the differential can clamp at 0
    throughput = NUM_CHANNELS * NUM_SAMPLES / median
    print(
        json.dumps(
            {
                "metric": f"epl_correlator_throughput_{ALGORITHM}_K{NUM_CHANNELS}_N{NUM_SAMPLES}",
                "value": throughput / 1e6,
                "unit": "Msamples/s",
                "vs_baseline": throughput / BASELINE_SAMPLES_PER_S,
                "median_ms_per_block": median * 1e3,
                "burst_ms_per_block": stats.minimum * 1e3,
                "device": device.describe(),
            }
        )
    )


if __name__ == "__main__":
    main()

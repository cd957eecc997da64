#!/usr/bin/env python
"""GPS L1 kernel benchmark sweep — `/root/reference/scripts/run_benchmarks_gpsl1.jl` analog.

Sweep: N = 2^11..2^18 samples per 1 ms (2–262 MHz), M ∈ {1, 4}, L ∈ {3, 7},
the per-channel paths and both bank correlators at K=1 on the default
device, plus the XLA-CPU baseline. Each config is
saved immediately (resume-safe) under data/benchmarks/kernel/.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from gpuacceleratedtracking_tpu.bench import run_kernel_benchmark, run_sweep

params = {
    "GNSS": "GPSL1",
    "num_samples": [2**e for e in range(11, 19)],
    "num_ants": [1, 4],
    "num_correlators": [3, 7],
    # Per-channel pipeline family + the two bank correlators at K=1.
    "algorithm": ["fused_xla", "unfused_xla", "xla_bank", "triton_bank"],
    # deep-unroll protocol: reps scale inversely with N (>= ~2 ms device
    # work per timed call) so small-N medians clear the dispatch cost
    "reps": "auto",
    "trials": 7,
}

# The CPU (XLA-CPU) baseline plays the reference's LoopVectorization SIMD
# role (`/root/reference/src/benchmarks.jl:35-80`) — XLA paths only (the
# Triton kernel runs only on the GPU).
cpu_params = dict(params, processor="CPU", reps=4, trials=7,
                  algorithm=["fused_xla", "unfused_xla", "xla_bank"])

if __name__ == "__main__":
    out = pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "kernel"
    run_sweep(params, run_kernel_benchmark, out, prefix="KernelBenchmark")
    run_sweep(cpu_params, run_kernel_benchmark, out, prefix="KernelBenchmark")

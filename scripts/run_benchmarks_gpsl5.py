#!/usr/bin/env python
"""GPS L5 kernel benchmark sweep — `/root/reference/scripts/run_benchmarks_gpsl5.jl` analog.

L5's 10.23 MHz chip rate needs ≥ ~20 MHz sampling, so N starts at 2^15.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from gpuacceleratedtracking_tpu.bench import run_kernel_benchmark, run_sweep

params = {
    "GNSS": "GPSL5",
    "num_samples": [2**e for e in range(15, 19)],
    "num_ants": [1, 4],
    "num_correlators": [3, 7],
    "algorithm": ["fused_xla", "unfused_xla", "xla_bank", "triton_bank"],
    # deep-unroll protocol: reps scale inversely with N (>= ~2 ms device
    # work per timed call) so small-N medians clear the dispatch cost
    "reps": "auto",
    "trials": 7,
}

cpu_params = dict(params, processor="CPU", reps=4, trials=7,
                  algorithm=["fused_xla", "unfused_xla", "xla_bank"])

if __name__ == "__main__":
    out = pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "kernel"
    run_sweep(params, run_kernel_benchmark, out, prefix="KernelBenchmark")
    run_sweep(cpu_params, run_kernel_benchmark, out, prefix="KernelBenchmark")

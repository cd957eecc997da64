#!/usr/bin/env python
"""Reduction fusion-degree sweep — `/root/reference/scripts/benchmark_reduction.jl` analog."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from gpuacceleratedtracking_tpu.bench import run_reduction_benchmark, run_sweep

params = {
    "num_samples": [2**e for e in range(11, 16)],
    "num_ants": 4,
    "num_correlators": 3,
    "algorithm": ["pure", "cplx", "cplx_multi"],
    # micro-kernels are ~us-scale: deep scan-carried reps lift the
    # differential estimate above the timing noise
    "reps": "auto",
    "trials": 7,
}

if __name__ == "__main__":
    out = pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "reduction"
    run_sweep(params, run_reduction_benchmark, out, prefix="ReductionBenchmark")

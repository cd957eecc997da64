#!/usr/bin/env python
"""Replica-generation sweep (exact vs quantized NCO) —
`/root/reference/scripts/benchmark_textmem.jl` analog."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from gpuacceleratedtracking_tpu.bench import run_replica_benchmark, run_sweep

params = {
    "GNSS": "GPSL1",
    "num_samples": [2**e for e in range(11, 19)],
    "algorithm": ["exact", "quantized"],
    # micro-kernels are ~us-scale: deep scan-carried reps lift the
    # differential estimate above the timing noise
    "reps": "auto",
    "trials": 7,
}

if __name__ == "__main__":
    out = pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "replica"
    run_sweep(params, run_replica_benchmark, out, prefix="ReplicaBenchmark")

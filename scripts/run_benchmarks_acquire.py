#!/usr/bin/env python
"""PCPS acquisition benchmark sweep on the default device (`jnp.fft`, cuFFT on
the GPU); ``--cpu`` runs it on the host CPU instead. Sweep axes: block length N (=> Doppler-bin count via the 2/(3T) default
grid), PRN-list size K, noncoherent rounds R.

Role match: Acquisition.jl -> Tracking.jl handoff in the reference ecosystem
(`/root/reference/src/benchmarks.jl:54`).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from gpuacceleratedtracking_tpu.bench import run_acquire_benchmark, run_sweep

params = {
    "GNSS": "GPSL1",
    "num_samples": [2048, 8192, 32768],
    "num_prns": [1, 8, 32],
    "rounds": [1, 6],
    "trials": 7,
}

l5_params = {
    "GNSS": "GPSL5",
    "num_samples": [32768],
    "num_prns": [1, 8, 32],
    "rounds": [1, 6],
    "trials": 7,
}

# BeiDou B1I (fifth family): same 1 ms code period as GPS L1 at double the
# chip rate — the PCPS shape is identical, so one N covers the family.
beidou_params = {
    "GNSS": "BEIDOUB1I",
    "num_samples": [8192],
    "num_prns": [8, 32],
    "rounds": [1, 6],
    "trials": 7,
}

if __name__ == "__main__":
    out = (
        pathlib.Path(__file__).parent.parent / "data" / "benchmarks"
        / "acquire"
    )
    if "--cpu" in sys.argv:
        params = dict(params, processor="CPU")
        l5_params = dict(l5_params, processor="CPU")
        beidou_params = dict(beidou_params, processor="CPU")
    run_sweep(params, run_acquire_benchmark, out, prefix="AcquireBenchmark")
    run_sweep(l5_params, run_acquire_benchmark, out, prefix="AcquireBenchmark")
    run_sweep(
        beidou_params, run_acquire_benchmark, out, prefix="AcquireBenchmark"
    )

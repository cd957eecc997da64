#!/usr/bin/env python
"""Closed-loop tracking benchmark sweep (no reference analog — the reference
exports `run_track_benchmark` without defining it,
`/root/reference/src/GPUAcceleratedTracking.jl:102`; its closed loops live in
the external Tracking.jl fork and are never benchmarked on GPU).

Sweep: channel-bank size K at the north-star 32.768 MHz GPS L1 scenario plus a
moderate 4.096 MHz rate, full DLL/PLL/FLL loop closure per 1 ms block. The
headline derived metric is ``realtime_channels``: how many satellite channels
one card tracks in real time. Each config saves immediately (resume-safe)
under data/benchmarks/track/.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from gpuacceleratedtracking_tpu.bench import (
    run_dual_track_benchmark,
    run_track_benchmark,
    run_sweep,
)

params = {
    "GNSS": "GPSL1",
    # K=512 is the per-card share of a K=1024 bank on a 2-card channel mesh
    # (`parallel.bank.track_bank_sharded`).
    "num_samples": [4096, 32768],
    "num_channels": [32, 256, 512, 1024],
    "num_ants": 1,
    "num_correlators": 3,
    "algorithm": ["triton_bank", "xla_bank"],
    "blocks": 8,
    "trials": 7,
}

# Multi-antenna closed loop (the reference's full sweep matrix is M in {1,4},
# `/root/reference/paper/paper.tex:304-309`): beamformed M=4 bank rows at the
# north-star rate, L in {3,7}.
m4_params = {
    "GNSS": "GPSL1",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_ants": 4,
    "num_correlators": [3, 7],
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

# GLONASS L1OF closed loop (third constellation family, beyond the
# reference's GPS-only GNSSDICT): the 511-chip m-sequence code through the
# same bank kernels; FDMA channel offsets ride the per-channel carrier
# frequency natively.
glonass_params = {
    "GNSS": "GLONASSL1",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_correlators": 3,
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

# Galileo E1-C BOC(1,1) closed loop (fourth constellation family): the
# subcarrier meander doubles the replica transition density, and the CS25
# overlay wipe-off (4 ms primary period over 1 ms blocks) rides the timed
# path. 32.768 MHz -> 0.0625 half-chips/sample: rows-kernel regime.
galileo_params = {
    "GNSS": "GALILEOE1C",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_correlators": 3,
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

# BeiDou B1I closed loop (fifth constellation family; the first fully
# register-generated family beyond GPS): 2046 chips/ms = exactly double GPS
# L1's transition density at the same 1 ms cadence, NH20 D1 overlay wipe-off
# in the timed path. 32.768 MHz -> 16 samples/chip: rows-kernel regime.
beidou_params = {
    "GNSS": "BEIDOUB1I",
    "num_samples": 32768,
    "num_channels": [64, 256],
    "num_correlators": 3,
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

# GPS L5 dual-component closed loop (the north-star L5 leg): K dual
# channels = 2K-channel bank per launch, NH10/NH20 wipe-off + pilot atan2
# closure in the timed path. The reference's L5 never closes a loop on GPU
# (`/root/reference/scripts/run_benchmarks_gpsl5.jl` is open-loop kernels).
dual_params = {
    "GNSS": "GPSL5",
    "num_samples": 32768,
    "num_channels": [16, 64, 128, 256],
    "num_correlators": 3,
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

# Wideband L5 front ends sample at >= 2x the 10.23 MHz code rate: 65.536 MHz
# is the deployed configuration.
dual_params_wide = {
    "GNSS": "GPSL5",
    "num_samples": 65536,
    "num_channels": [16, 64, 128, 256],
    "num_correlators": 3,
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

# Wide-span cells — the TOP of the reference envelope (L1 at 131/262 MHz,
# `/root/reference/scripts/run_benchmarks_gpsl1.jl:8` N=2^17/2^18), where one
# EPL chip spans >= 128 samples.
wide_params = {
    "GNSS": "GPSL1",
    "num_samples": [131072, 262144],
    "num_channels": [256, 1024],
    "num_ants": 1,
    "num_correlators": 3,
    "algorithm": ["triton_bank"],
    "blocks": 8,
    "trials": 7,
}

if __name__ == "__main__":
    out = pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "track"
    run_sweep(params, run_track_benchmark, out, prefix="TrackBenchmark")
    run_sweep(m4_params, run_track_benchmark, out, prefix="TrackBenchmark")
    run_sweep(glonass_params, run_track_benchmark, out, prefix="TrackBenchmark")
    run_sweep(galileo_params, run_track_benchmark, out, prefix="TrackBenchmark")
    run_sweep(beidou_params, run_track_benchmark, out, prefix="TrackBenchmark")
    run_sweep(
        dual_params, run_dual_track_benchmark, out, prefix="DualTrackBenchmark"
    )
    run_sweep(
        dual_params_wide, run_dual_track_benchmark, out,
        prefix="DualTrackBenchmark",
    )
    run_sweep(wide_params, run_track_benchmark, out, prefix="TrackBenchmark")

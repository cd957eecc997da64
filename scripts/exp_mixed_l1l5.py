#!/usr/bin/env python
"""Mixed-constellation closed-loop benchmark: L1 bank + L5 dual bank, one card.

One card runs BOTH a K1-channel GPS L1 bank (32.768 MHz) AND a K5-channel GPS
L5 dual-component bank (2·K5 bank channels, NH wipe-off + pilot atan2
closure) every 1 ms block, strictly sequentially on the single device stream,
through the platform's bank correlator (``bank``: ``triton_bank`` on the
GPU). The reference never times any closed loop on GPU, let
alone a mixed-band one (`/root/reference/scripts/run_benchmarks_gpsl5.jl` is
open-loop; its paper calls L5 M=4 L=7 unsolved, paper.tex:345).

Timing: paired-unroll differential medians over block count (dispatch cost
cancels; the fence waits on a scalar combining BOTH banks' outputs). Output: data/benchmarks/track/MixedTrack_*.json per scenario.

Scenarios: (512 L1 + 32 L5-dual) — the VERDICT ask — and (960 L1 + 64
L5-dual) = 1024 total satellite channels on one card.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from gpuacceleratedtracking_tpu.models import GPSL1, GPSL5, gen_signal, soa
from gpuacceleratedtracking_tpu.bench.harness import (
    REALTIME_BOUND_S,
    add_metadata,
)
from gpuacceleratedtracking_tpu.bench.timing import benchmark_differential
from gpuacceleratedtracking_tpu.tracking import (
    TrackConfig,
    dual_config,
    init_state,
    track_bank,
    track_bank_dual,
)

N = 32768
ALGORITHM = "bank"
BLOCKS = 8
TRIALS = 7
# (L1 channels, L5 dual channels, L5 samples per 1 ms block): 32.768 MHz
# and the 65.536 MHz wideband L5 front end.
SCENARIOS = [(512, 32, 32768), (960, 64, 32768), (960, 64, 65536)]


def build(k1, k5, n5):
    fs = N / 1e-3
    fs5 = n5 / 1e-3
    l1 = GPSL1()
    l5i, l5q = GPSL5(), GPSL5(quadrature=True)

    cfg1 = TrackConfig.for_system(l1, fs, N, algorithm=ALGORITHM)
    cfg5 = dual_config(TrackConfig.for_system(
        l5i, fs5, n5, algorithm=ALGORITHM, use_secondary=False,
    ))

    st1 = init_state(
        np.arange(k1) % l1.codes.shape[1],
        carrier_doppler=np.linspace(-4000.0, 4000.0, k1),
    )
    st5 = init_state(
        np.arange(k5) % l5i.codes.shape[1],
        carrier_doppler=np.linspace(-4000.0, 4000.0, k5),
    )
    codes1 = jnp.asarray(l1.codes)
    codes5i = jnp.asarray(l5i.codes)
    codes5q = jnp.asarray(l5q.codes)

    def make_fn(b):
        s1, _ = gen_signal(l1, 0, 1500.0, N * b, duration=b * 1e-3)
        s5, _ = gen_signal(
            l5i, 0, 1500.0, n5 * b, duration=b * 1e-3,
            secondary_code=l5i.secondary_code,
        )
        sre1, sim1 = (x.reshape(b, N) for x in soa(s1))
        sre5, sim5 = (x.reshape(b, n5) for x in soa(s5))

        @jax.jit
        def fence(o1, o5):
            return o1.prompt_re.sum() + o5.pilot.prompt_re.sum()

        def run():
            _, o1 = track_bank(cfg1, codes1, st1, sre1, sim1)
            _, o5 = track_bank_dual(cfg5, codes5i, codes5q, st5, sre5, sim5)
            # The fence leaf depends on BOTH banks (single device stream).
            return fence(o1, o5)

        return run, ()

    return make_fn


def main():
    out_dir = (
        pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "track"
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    for k1, k5, n5 in SCENARIOS:
        path = (out_dir
                / f"MixedTrack_L1={k1}_L5dual={k5}_num_samples={N}"
                  f"_l5_num_samples={n5}.json")
        if path.exists():
            print(f"skip (exists): {path.name}")
            continue
        make_fn = build(k1, k5, n5)
        stats = benchmark_differential(make_fn, BLOCKS, trials=TRIALS)
        floor = max(stats.median, 1e-9)
        total = k1 + k5
        res = {
            "GNSS": "GPSL1+GPSL5",
            "num_samples": N,
            "l5_num_samples": n5,
            "l1_channels": k1,
            "l5_dual_channels": k5,
            "bank_channels": k1 + 2 * k5,
            "blocks": BLOCKS,
            "trials": TRIALS,
        }
        res.update(stats.to_dict())
        res["realtime_ratio"] = floor / REALTIME_BOUND_S
        res["realtime_channels"] = total * REALTIME_BOUND_S / floor
        res["samples_per_s"] = (k1 + 2 * k5) * N / floor
        # Cards needed so THIS mix runs inside real time, ASSUMING linear
        # scaling when the mix splits across cards.
        res["cards_for_realtime_linear_est"] = int(
            np.ceil(floor / REALTIME_BOUND_S)
        )
        add_metadata(res, jax.devices()[0], ALGORITHM)
        path.write_text(json.dumps(res, indent=1))
        print(json.dumps({k: res[k] for k in (
            "l1_channels", "l5_dual_channels", "Median", "realtime_ratio",
            "realtime_channels", "cards_for_realtime_linear_est",
        )}))


if __name__ == "__main__":
    main()

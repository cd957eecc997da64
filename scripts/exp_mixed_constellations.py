#!/usr/bin/env python
"""Five-constellation closed-loop mix on ONE card — the full-receiver demo.

One device stream runs, every 1 ms block, closed-loop banks for ALL FIVE
supported families strictly sequentially:

  GPS L1 C/A + GLONASS L1OF (FDMA offsets ride the per-channel carrier) +
  Galileo E1-C BOC(1,1) (CS25 overlay wipe-off) + BeiDou B1I (NH20 wipe-off)
  + GPS L5 dual-component (NH10/NH20 wipe-off + pilot atan2 closure),

each through the platform's bank correlator (``bank``: ``triton_bank`` on
the GPU).

This is the workload of a production multi-GNSS receiver — the reference
tracks nothing closed-loop on GPU and supports two families open-loop
(`GNSSDICT`, `/root/reference/src/GPUAcceleratedTracking.jl:39-42`).

Timing protocol = exp_mixed_l1l5.py: paired-unroll differential medians over
block count (dispatch cancels), fence on a scalar combining every bank's
output (single device stream ⇒ all five finished). Output: data/benchmarks/track/MixedConstellations_*.json.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from gpuacceleratedtracking_tpu.models import (
    BeiDouB1I, GPSL1, GPSL5, GalileoE1, GLONASSL1, gen_signal, soa,
)
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

N = 32768            # all families at 32.768 MHz front ends
ALGORITHM = "bank"
BLOCKS = 32
TRIALS = 7
# (K_l1, K_glo, K_e1c, K_b1i, K_l5dual). 256+64+64+64+16 = 464 satellite
# channels.
SCENARIOS = [(256, 64, 64, 64, 16)]


def build(k1, kg, ke, kb, k5):
    fs = N / 1e-3
    systems = [
        ("GPSL1", GPSL1(), k1),
        ("GLONASSL1", GLONASSL1(), kg),
        ("GALILEOE1C", GalileoE1(pilot=True), ke),
        ("BEIDOUB1I", BeiDouB1I(), kb),
    ]
    banks = []       # (cfg, codes, states) for the four single-bank families
    for name, sys_o, k in systems:
        cfg = TrackConfig.for_system(sys_o, fs, N, algorithm=ALGORITHM)
        st = init_state(
            np.arange(k) % sys_o.codes.shape[1],
            carrier_doppler=np.linspace(-4000.0, 4000.0, k),
        )
        banks.append((name, sys_o, cfg, jnp.asarray(sys_o.codes), st))

    l5i, l5q = GPSL5(), GPSL5(quadrature=True)
    cfg5 = dual_config(TrackConfig.for_system(
        l5i, fs, N, algorithm=ALGORITHM, use_secondary=False,
    ))
    st5 = init_state(
        np.arange(k5) % l5i.codes.shape[1],
        carrier_doppler=np.linspace(-4000.0, 4000.0, k5),
    )
    codes5i, codes5q = jnp.asarray(l5i.codes), jnp.asarray(l5q.codes)

    def make_fn(b):
        plane_sets = []
        for name, sys_o, cfg, codes, st in banks:
            s, _ = gen_signal(
                sys_o, 0, 1500.0, N * b, duration=b * 1e-3,
                secondary_code=sys_o.secondary_code,
            )
            plane_sets.append(tuple(x.reshape(b, N) for x in soa(s)))
        s5, _ = gen_signal(
            l5i, 0, 1500.0, N * b, duration=b * 1e-3,
            secondary_code=l5i.secondary_code,
        )
        sre5, sim5 = (x.reshape(b, N) for x in soa(s5))

        @jax.jit
        def fence(*prompt_sums):
            return sum(prompt_sums)

        def run():
            sums = []
            for (name, sys_o, cfg, codes, st), (sre, sim) in zip(
                banks, plane_sets
            ):
                _, o = track_bank(cfg, codes, st, sre, sim)
                sums.append(o.prompt_re.sum())
            _, o5 = track_bank_dual(cfg5, codes5i, codes5q, st5, sre5, sim5)
            sums.append(o5.pilot.prompt_re.sum())
            return fence(*sums)

        return run, ()

    return make_fn


def main():
    out_dir = (
        pathlib.Path(__file__).parent.parent / "data" / "benchmarks" / "track"
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    for k1, kg, ke, kb, k5 in SCENARIOS:
        path = (out_dir
                / f"MixedConstellations_L1={k1}_GLO={kg}_E1C={ke}"
                  f"_B1I={kb}_L5dual={k5}_num_samples={N}.json")
        if path.exists():
            print(f"skip (exists): {path.name}")
            continue
        make_fn = build(k1, kg, ke, kb, k5)
        stats = benchmark_differential(make_fn, BLOCKS, trials=TRIALS)
        floor = max(stats.median, 1e-9)
        total = k1 + kg + ke + kb + k5
        res = {
            "GNSS": "MULTIGNSS5",
            "num_samples": N,
            "channels": {"GPSL1": k1, "GLONASSL1": kg, "GALILEOE1C": ke,
                         "BEIDOUB1I": kb, "GPSL5_dual": k5},
            "total_channels": total,
            "bank_channels": k1 + kg + ke + kb + 2 * k5,
            "blocks": BLOCKS,
            "trials": TRIALS,
        }
        res.update(stats.to_dict())
        res["realtime_ratio"] = floor / REALTIME_BOUND_S
        # Cards so THIS mix runs inside real time, assuming per-family costs
        # split linearly across cards: an estimate.
        res["cards_for_realtime_linear_est"] = int(
            np.ceil(floor / REALTIME_BOUND_S))
        add_metadata(res, jax.devices()[0], ALGORITHM)
        path.write_text(json.dumps(res, indent=1))
        print(json.dumps({k: res[k] for k in (
            "total_channels", "Median", "Minimum", "realtime_ratio",
            "cards_for_realtime_linear_est")}))


if __name__ == "__main__":
    main()

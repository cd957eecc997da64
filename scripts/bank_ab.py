#!/usr/bin/env python
"""Bank correlator A/B on one GPU, end to end inside ``track_bank``.

    python scripts/bank_ab.py [--blocks 16] [--rounds 5] [--out FILE]

For each flagship shape of ``chip_smoke.SHAPES`` it compiles ``track_bank``
with the plain XLA bank (``xla_bank``) and the Pallas kernel
(``triton_bank``), prints the buffers of ``[K, N]`` size or more that leave a
fusion (`bench.hlo.unfused_buffers`) and the compiled temp size, checks the
kernel's accumulators against ``xla_bank``, and times ``blocks`` closed-loop
blocks per call in alternating order (a, b, b, a, ...). Times are medians of
``rounds`` calls per candidate, divided by ``blocks``; the card's
``nvidia-smi`` name and power limit go with them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--blocks", type=int, default=16)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--out", default="chiprun_out/bank_ab.json")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from gpuacceleratedtracking_tpu import device
    from gpuacceleratedtracking_tpu.bench.hlo import unfused_buffers
    from gpuacceleratedtracking_tpu.tracking import TrackConfig, track_bank

    device.enable_compile_cache()
    device.require_gpu()
    card = device.nvidia_smi()
    print(card, device.describe(), flush=True)
    candidates = ["xla_bank", "triton_bank"]
    report = {"card": card, "device": device.describe(), "shapes": {}}
    for name, (sysname, k, n, a, l) in cs.SHAPES.items():
        system = cs._gt().models.get_system(sysname)
        fs, sre, sim, states, _ = cs._bank_scene(system, k, n, a, args.blocks, 0)
        codes = jnp.asarray(system.codes)
        fns, outs, row = {}, {}, {}
        for algo in candidates:
            cfg = TrackConfig.for_system(system, fs, n, num_correlators=l,
                                         algorithm=algo, use_secondary=False)
            t0 = time.perf_counter()
            try:
                compiled = track_bank.lower(cfg, codes, states, sre,
                                            sim).compile()
            except Exception:       # report the refusal, time the others
                traceback.print_exc()
                continue
            t_compile = time.perf_counter() - t0
            fns[algo] = lambda c=compiled: c(codes, states, sre, sim)
            outs[algo] = jax.block_until_ready(fns[algo]())
            mem = compiled.memory_analysis()
            big = unfused_buffers(compiled.as_text(), k * n)
            row[algo] = {"compile_s": t_compile, "unfused_KN_buffers": len(big),
                         "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
                         "times": []}
            print(f"{name} {algo}: compile {t_compile:.1f} s, "
                  f"{len(big)} unfused >=K*N buffers {big[:4]}, "
                  f"temp {row[algo]['temp_bytes']}", flush=True)
        ran = [c for c in candidates if c in fns]
        ref = outs["xla_bank"][1]
        for algo in ran:
            out = outs[algo][1]
            dev = max(float(np.abs(np.asarray(x)[0] - np.asarray(y)[0]).max())
                      for x, y in ((out.accum_re, ref.accum_re),
                                   (out.accum_im, ref.accum_im)))
            row[algo]["block0_dev_over_N"] = dev / n
        for r in range(args.rounds):
            order = ran if r % 2 == 0 else ran[::-1]
            for algo in order:
                t0 = time.perf_counter()
                jax.block_until_ready(fns[algo]())
                row[algo]["times"].append(
                    (time.perf_counter() - t0) / args.blocks)
        for algo in ran:
            med = statistics.median(row[algo]["times"])
            row[algo]["median_ms_per_block"] = med * 1e3
            print(f"{name} {algo}: {med * 1e3:.4f} ms/block median, "
                  f"min {min(row[algo]['times']) * 1e3:.4f}, "
                  f"dev/N {row[algo]['block0_dev_over_N']:.3g}", flush=True)
        report["shapes"][name] = row
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Accumulator accuracy vs a float64 oracle, across the sweep envelope.

Makes BASELINE.json's "accumulator SNR delta vs the CPU reference" a measured
number: for each (GNSS, N) cell of the kernel-benchmark envelope and each
algorithm x dtype-mode, correlate a noisy multi-satellite front end and report
the accumulator error against an independently-written float64 oracle —
max/mean relative error and accumulator SNR (dB). The accuracy analog of
data/benchmarks/replica_accuracy.json; reference bar: the paper's SNR-bound
discussion (`/root/reference/paper/paper.tex:322-331`).

Paths, all f32: `fused_xla` (single channel, `HIGHEST`-precision einsum),
`xla_bank` and `triton_bank` (the Triton kernel runs only on the GPU; on the
CPU its row reports the error). Output:
data/benchmarks/accumulator_accuracy.json.
"""

import functools
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from gpuacceleratedtracking_tpu.models import (
    GPSL1,
    GPSL5,
    EPLCorrelator,
    correlator_sample_shifts,
    gen_signal,
)
from gpuacceleratedtracking_tpu.bench import oracle as f64
from gpuacceleratedtracking_tpu.ops import registry

K = 8           # channels per cell (error stats over K x L accumulators)
SIGMA = 2.0     # AWGN per component (signal amplitude 1 per satellite)
ENVELOPE = {
    "GPSL1": [2 ** e for e in range(11, 19)],
    "GPSL5": [2 ** e for e in range(15, 19)],
}


def cell(system, gnss, num_samples):
    fs = num_samples / 1e-3
    rng = np.random.default_rng(num_samples)
    num_prns = system.codes.shape[1]
    prns = (np.arange(K) * 3) % num_prns
    dops = rng.uniform(-4000.0, 4000.0, K)
    phis_car = rng.uniform(0, 2 * np.pi, K)
    phis_code = rng.uniform(0, system.code_length, K)
    fcode = system.code_frequency * (1.0 + dops / system.center_frequency)

    # Front end: all K satellites superposed + AWGN, host f64 for the oracle.
    mixed = None
    for i in range(K):
        s, _ = gen_signal(
            system, int(prns[i]), float(dops[i]), num_samples,
            start_carrier_phase=float(phis_car[i]),
            start_code_phase=float(phis_code[i]),
            code_frequency=float(fcode[i]),
        )
        s = np.asarray(s)
        mixed = s if mixed is None else mixed + s
    mixed = mixed.astype(np.complex128) + SIGMA * (
        rng.standard_normal(num_samples)
        + 1j * rng.standard_normal(num_samples)
    )
    sig32 = mixed.astype(np.complex64)
    sre = jnp.asarray(sig32.real)
    sim = jnp.asarray(sig32.imag)
    codes = jnp.asarray(system.codes)
    shifts = tuple(int(x) for x in correlator_sample_shifts(
        system, EPLCorrelator(3), fs))

    # Oracle on the SAME f32-quantized signal: isolates kernel arithmetic
    # error from front-end quantization.
    oracle = np.stack([
        f64.correlate(sig32, system.codes, int(prns[i]), float(dops[i]), fs,
                      float(phis_car[i]), float(fcode[i]),
                      float(phis_code[i]), shifts)
        for i in range(K)
    ])                                            # [K, L] complex

    prn_a = jnp.asarray(prns, jnp.int32)
    f_car = jnp.asarray(dops, jnp.float32)
    ph_car = jnp.asarray(phis_car, jnp.float32)        # radians
    f_code = jnp.asarray(fcode, jnp.float32)
    ph_code = jnp.asarray(phis_code, jnp.float32)      # chips

    def per_chan(fn):
        one = jax.jit(
            lambda p, fc, pc, fcd, pcd: fn(
                sre, sim, codes, p, fc, fs, pc, fcd, pcd, shifts,
                system.code_length,
            )
        )
        are, aim = jax.jit(jax.vmap(one))(
            prn_a, f_car, ph_car, f_code, ph_code
        )
        return np.asarray(are) + 1j * np.asarray(aim)

    def bank(fn):
        jfn = jax.jit(functools.partial(
            fn, sampling_frequency=fs, sample_shifts=shifts,
            code_length=system.code_length,
        ))
        are, aim = jfn(
            sre, sim, codes, prn_a, f_car, carrier_phase=ph_car,
            code_frequency=f_code, code_phase=ph_code,
        )
        return np.asarray(are) + 1j * np.asarray(aim)

    variants = {
        "fused_xla": lambda: per_chan(registry.get("fused_xla")),
        "xla_bank": lambda: bank(registry.get("xla_bank")),
        "triton_bank": lambda: bank(registry.get("triton_bank")),
    }

    scale = np.abs(oracle).max()
    rms_sig = np.sqrt(np.mean(np.abs(oracle) ** 2))
    rows = {}
    for name, fn in variants.items():
        try:
            got = fn()
        except Exception as e:
            rows[name] = {"error": repr(e)[:200]}
            continue
        err = np.abs(got - oracle)
        rms_err = np.sqrt(np.mean(err ** 2))
        rows[name] = {
            "max_rel": float(err.max() / scale),
            "mean_rel": float(err.mean() / scale),
            "snr_db": float(
                20 * np.log10(rms_sig / rms_err) if rms_err > 0 else np.inf
            ),
        }
    return rows


def main():
    out = {"config": {"K": K, "sigma": SIGMA, "num_correlators": 3,
                      "backend": jax.default_backend()},
           "cells": []}
    for gnss, ns in ENVELOPE.items():
        system = GPSL1() if gnss == "GPSL1" else GPSL5()
        for n in ns:
            rows = cell(system, gnss, n)
            out["cells"].append(
                {"GNSS": gnss, "num_samples": n, "algorithms": rows}
            )
            worst = {k: v.get("max_rel") for k, v in rows.items()}
            print(gnss, n, json.dumps(worst))
    path = (pathlib.Path(__file__).parent.parent
            / "data" / "benchmarks" / "accumulator_accuracy.json")
    path.write_text(json.dumps(out, indent=1))
    print("wrote", path)


if __name__ == "__main__":
    main()

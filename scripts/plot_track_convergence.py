#!/usr/bin/env python
"""Closed-loop convergence figure: DLL/PLL/FLL pull-in of a Doppler-offset
synthetic signal (the capability the reference delegates to its Tracking.jl
fork, `/root/reference/src/benchmarks.jl:54-79`; no reference analog figure).

Two scenarios on the golden GPS L1 setup (N=2500 @ 2.5 MHz, PRN 1):
a noiseless 212 Hz acquisition-handoff Doppler error, and the same with
~45 dB-Hz AWGN. Plots Doppler error, code-phase error (chips), and the C/N0
estimate over a 1 s track. CPU-runnable (pure XLA loop); output
img/track_convergence.png.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from gpuacceleratedtracking_tpu.models import GPSL1, gen_signal, soa
from gpuacceleratedtracking_tpu.tracking import TrackConfig, init_state, track

NUM_MS = 1000
N = 2500
DOPPLER_ERR = 212.0


def run(noise_std, seed, true_doppler=1500.0):
    system = GPSL1()
    fs = N / 1e-3
    scale = 1.0 + true_doppler / system.center_frequency
    code_freq_true = system.code_frequency * scale
    key = jax.random.key(seed) if noise_std > 0 else None
    signal, _ = gen_signal(
        system, 0, true_doppler, N * NUM_MS, duration=NUM_MS * 1e-3,
        code_frequency=code_freq_true, start_carrier_phase=0.3,
        noise_std=noise_std, key=key,
    )
    sre, sim = soa(signal)
    config = TrackConfig.for_system(system, fs, N)
    state = init_state(0, carrier_doppler=true_doppler + DOPPLER_ERR)
    _, out = track(config, jnp.asarray(system.codes), state,
                   sre.reshape(NUM_MS, N), sim.reshape(NUM_MS, N))
    b = np.arange(NUM_MS)
    true_phase = (code_freq_true * 1e-3 * (b + 1)) % system.code_length
    est_phase = np.asarray(out.code_phase)
    half = system.code_length / 2
    code_err = (est_phase - true_phase + half) % system.code_length - half
    return {
        "dop_err": np.asarray(out.carrier_doppler) - true_doppler,
        "code_err": code_err,
        "cn0": np.asarray(out.cn0_dbhz),
    }


def main(out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = {
        "noiseless": run(0.0, 0),
        "~45 dB-Hz AWGN": run(2.0, 7),
    }
    t = np.arange(NUM_MS)  # ms
    fig, axes = plt.subplots(3, 1, figsize=(7.2, 7.5), sharex=True)
    for label, r in runs.items():
        axes[0].plot(t, r["dop_err"], lw=1, label=label)
        axes[1].plot(t, r["code_err"], lw=1, label=label)
        axes[2].plot(t, r["cn0"], lw=1, label=label)
    axes[0].axhline(0, color="k", lw=0.5)
    axes[0].set_ylabel("Doppler error [Hz]")
    axes[0].set_title(
        f"Closed-loop pull-in: {DOPPLER_ERR:.0f} Hz handoff error, "
        "GPS L1 @ 2.5 MHz (FLL-assisted PLL + DLL)",
        fontsize=10,
    )
    axes[1].axhline(0, color="k", lw=0.5)
    axes[1].set_ylabel("code phase error [chips]")
    axes[2].set_ylabel("C/N0 est. [dB-Hz]")
    axes[2].set_xlabel("time [ms]")
    for ax in axes:
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    # Convergence annotations: mean |Doppler error| over the last 50 ms.
    final = {k: abs(r["dop_err"][-50:]).mean() for k, r in runs.items()}
    axes[0].text(
        0.99, 0.05,
        " / ".join(f"{k}: |err| last 50 ms = {v:.2f} Hz" for k, v in final.items()),
        transform=axes[0].transAxes, ha="right", fontsize=7,
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    print(out_path)
    for k, v in final.items():
        print(f"  {k}: mean |doppler err| over last 50 ms = {v:.3f} Hz")


if __name__ == "__main__":
    out = pathlib.Path(__file__).parent.parent / "img" / "track_convergence.png"
    main(str(out))

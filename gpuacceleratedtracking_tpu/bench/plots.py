"""Benchmark figures — the `src/plots.jl` / `scripts/plot_benchmarks.jl` analog.

Three figure families, all against the 1 ms real-time bound the paper plots as
a horizontal line (`/root/reference/src/plots.jl:57`,
`scripts/plot_benchmarks.jl:111`):

- `plot_kernel_benchmarks`: processing time vs sampling frequency per
  algorithm (the paper's 2×3 grid of GNSS × antenna/correlator configs),
- `plot_reduction_benchmark`: grouped bars of pure/cplx/cplx_multi,
- `plot_replica_benchmark`: log-log replica generation time, exact vs
  quantized NCO.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

REALTIME_BOUND_S = 1e-3


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_kernel_benchmarks(df, out_path: str, title: Optional[str] = None):
    """Grid of processing-time-vs-sampling-rate curves, one panel per
    (GNSS, num_ants, num_correlators), one line per algorithm."""
    plt = _mpl()
    panels = sorted(
        df.groupby(["GNSS", "num_ants", "num_correlators"]).groups.keys()
    )
    ncols = min(3, len(panels))
    nrows = (len(panels) + ncols - 1) // ncols
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(5 * ncols, 3.6 * nrows), squeeze=False
    )
    for ax_idx, key in enumerate(panels):
        gnss, ants, corrs = key
        ax = axes[ax_idx // ncols][ax_idx % ncols]
        panel = df[
            (df.GNSS == gnss)
            & (df.num_ants == ants)
            & (df.num_correlators == corrs)
        ]
        # One line per (algorithm, processor): the CPU (XLA-CPU SIMD) baseline
        # rides the same panels as the reference's CPU-vs-GPU overlay
        # (`/root/reference/scripts/plot_benchmarks.jl`), dashed.
        keys = ["algorithm"]
        if "processor" in panel.columns:
            keys.append("processor")
        for gkey, grp in panel.groupby(keys):
            # pandas >= 3.0 yields 1-tuples even for single-key groupbys.
            if not isinstance(gkey, tuple):
                gkey = (gkey,)
            algo, proc = gkey if len(gkey) == 2 else (gkey[0], "")
            grp = grp.sort_values("num_samples")
            fs_mhz = grp.num_samples / 1e3  # N per 1 ms -> kHz -> MHz
            # Median (differential minima can clamp to 0 under noise); clip to the measurement floor so log scale stays drawable.
            t = grp.Median.clip(lower=2e-6)
            is_cpu = str(proc).upper() == "CPU"
            ax.loglog(
                fs_mhz, t, marker="o", ms=3, ls="--" if is_cpu else "-",
                alpha=0.6 if is_cpu else 1.0,
                label=f"{algo} (CPU)" if is_cpu else algo,
            )
        ax.axhline(REALTIME_BOUND_S, color="k", ls="--", lw=1, label="real-time")
        ax.set_title(f"{gnss}  M={ants}  L={corrs}", fontsize=10)
        ax.set_xlabel("sampling rate [MHz]")
        ax.set_ylabel("time per 1 ms block [s]")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=7)
    for j in range(len(panels), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_reduction_benchmark(df, out_path: str):
    """Grouped bars of reduction time per fusion degree vs N
    (`/root/reference/src/plots.jl:68-135`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4))
    sizes = sorted(df.num_samples.unique())
    algos = ["pure", "cplx", "cplx_multi"]
    algos = [a for a in algos if a in set(df.algorithm)]
    width = 0.8 / max(len(algos), 1)
    x = np.arange(len(sizes))
    for i, algo in enumerate(algos):
        grp = (
            df[df.algorithm == algo]
            .groupby("num_samples")["Median"]
            .min()
            .reindex(sizes)
        )
        ax.bar(x + i * width, grp.clip(lower=2e-6).values * 1e6, width,
               label=algo)
    ax.set_xticks(x + width * (len(algos) - 1) / 2)
    ax.set_xticklabels([f"2^{int(np.log2(s))}" for s in sizes])
    ax.set_xlabel("num samples")
    ax.set_ylabel("reduction time [µs]")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_replica_benchmark(df, out_path: str):
    """Log-log replica generation time vs sampling rate, exact vs quantized
    (`/root/reference/src/plots.jl:1-66`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    for algo, grp in df.groupby("algorithm"):
        grp = grp.sort_values("num_samples")
        ax.loglog(
            grp.num_samples / 1e3, grp.Median.clip(lower=2e-6),
            marker="o", ms=3, label=algo,
        )
    ax.axhline(REALTIME_BOUND_S, color="k", ls="--", lw=1, label="real-time")
    ax.set_xlabel("sampling rate [MHz]")
    ax.set_ylabel("replica generation time [s]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_track_benchmark(df, out_path: str):
    """Closed-loop bank: ms/block vs channel count per algorithm and rate,
    with the 1 ms real-time bound (no reference analog — its track benchmark
    is a dead export, `/root/reference/src/GPUAcceleratedTracking.jl:102`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7.5, 4.4))
    if "num_ants" not in df:
        df = df.assign(num_ants=1)
    if "GNSS" not in df:
        df = df.assign(GNSS="GPSL1")
    # Sweep configs that omit defaulted keys (num_ants for M=1 family rows,
    # L=3) read back as NaN, and pandas groupby DROPS NaN keys — which
    # silently removed those lines from the figure. Fill the defaults.
    df = df.assign(
        num_ants=df.num_ants.fillna(1),
        num_correlators=df.num_correlators.fillna(3),
    )
    # Mixed-constellation rows (no num_channels axis) live in their own
    # table (eval_summary); this figure plots K-sweeps only.
    df = df[df.num_channels.notna()] if "num_channels" in df else df
    if "bank_channels" not in df:
        df = df.assign(bank_channels=float("nan"))
    keys = ["GNSS", "algorithm", "num_samples", "num_ants",
            "num_correlators"]
    for (gnss, algo, n, m, l), grp in df.groupby(keys):
        grp = grp.sort_values("num_channels")
        label = f"{algo} @ {n / 1e3:g} MHz"
        is_dual = grp.bank_channels.notna().any()
        if is_dual:
            # Dual-component rows: K counts DUAL channels (2K-channel bank).
            label = f"{gnss[3:]}-dual {label}"
        elif gnss != "GPSL1":
            label = f"{gnss} {label}"
        if (m, l) != (1, 3):
            label += f" M={m} L={l}"
        ax.loglog(
            grp.num_channels, grp.Median.clip(lower=2e-6),
            marker="o", ms=4, label=label,
        )
    ax.axhline(REALTIME_BOUND_S, color="k", ls="--", lw=1, label="real-time")
    ax.set_xlabel("channels K")
    ax.set_ylabel("closed-loop time per 1 ms block [s]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path

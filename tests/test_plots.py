"""Smoke tests for the figure layer (Agg backend, synthetic frames)."""

import numpy as np
import pandas as pd
import pytest

from gpuacceleratedtracking_tpu.bench.plots import (
    plot_kernel_benchmarks,
    plot_reduction_benchmark,
    plot_replica_benchmark,
)


def _kernel_frame():
    rows = []
    for algo in ["triton_bank", "fused_xla"]:
        for ants in [1, 4]:
            for n in [2048, 8192, 32768]:
                rows.append(
                    {
                        "GNSS": "GPSL1",
                        "num_ants": ants,
                        "num_correlators": 3,
                        "num_samples": n,
                        "algorithm": algo,
                        "Median": 1e-6 * n / 2048 * (1 if algo.startswith("t") else 3),
                    }
                )
    return pd.DataFrame(rows)


def test_kernel_figure(tmp_path):
    out = plot_kernel_benchmarks(
        _kernel_frame(), str(tmp_path / "kernel.png"), title="t"
    )
    assert (tmp_path / "kernel.png").stat().st_size > 10_000


def test_reduction_figure(tmp_path):
    df = pd.DataFrame(
        {
            "algorithm": ["pure", "cplx", "cplx_multi"] * 2,
            "num_samples": [2048] * 3 + [4096] * 3,
            "Median": [6e-5, 7e-6, 1e-6, 1.2e-4, 1.4e-5, 2e-6],
        }
    )
    plot_reduction_benchmark(df, str(tmp_path / "red.png"))
    assert (tmp_path / "red.png").stat().st_size > 10_000


def test_replica_figure(tmp_path):
    df = pd.DataFrame(
        {
            "algorithm": ["exact"] * 3 + ["quantized"] * 3,
            "num_samples": [2048, 8192, 32768] * 2,
            "Median": [1e-4, 1.5e-4, 1.8e-4, 0.8e-4, 1.2e-4, 1.5e-4],
        }
    )
    plot_replica_benchmark(df, str(tmp_path / "rep.png"))
    assert (tmp_path / "rep.png").stat().st_size > 10_000

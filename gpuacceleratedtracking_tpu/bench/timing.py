"""Timing protocol: min-of-k trials around `jax.block_until_ready`.

The reference's BenchmarkTools-minimum-under-`CUDA.@sync` protocol
(`/root/reference/paper/paper.tex:147-150`, `src/benchmarks.jl:1-9`): the
minimum estimator rejects scheduling noise; `jax.block_until_ready` is the
sync fence. Per-call host→device dispatch can dwarf microsecond kernels, so
the measured callable may batch ``reps`` inner iterations inside one jitted
call and we divide time by ``reps``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Sequence

import jax


@dataclasses.dataclass
class TrialStats:
    """Min/median/mean/std/max over trials, seconds (per inner rep)."""

    times: list          # raw per-rep trial times [s]
    minimum: float
    median: float
    mean: float
    std: float
    maximum: float

    @classmethod
    def from_times(cls, times: Sequence[float]) -> "TrialStats":
        ts = list(times)
        return cls(
            times=ts,
            minimum=min(ts),
            median=statistics.median(ts),
            mean=statistics.fmean(ts),
            std=statistics.stdev(ts) if len(ts) > 1 else 0.0,
            maximum=max(ts),
        )

    def to_dict(self) -> dict:
        return {
            "Minimum": self.minimum,
            "Median": self.median,
            "Mean": self.mean,
            "Std": self.std,
            "Maximum": self.maximum,
            "times": self.times,
        }


def benchmark(
    fn: Callable,
    *args,
    trials: int = 7,
    reps: int = 1,
    warmup: int = 1,
) -> TrialStats:
    """Time ``fn(*args)`` with the min-estimator protocol.

    ``reps`` declares how many inner iterations one ``fn`` call amortizes
    (trial time is divided by it). ``warmup`` calls trigger compilation.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) / reps)
    return TrialStats.from_times(times)


def benchmark_pipelined(
    fn: Callable,
    arg_sets: Sequence[tuple],
    trials: int = 7,
) -> TrialStats:
    """Time ``fn`` by enqueueing one async dispatch per arg-set and fencing
    once at the end (device streams execute in order, so the last output
    being ready implies all are done). Per-call time = total / len(arg_sets).
    """
    jax.block_until_ready(fn(*arg_sets[0]))  # compile + settle
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        outs = [fn(*a) for a in arg_sets]
        jax.block_until_ready(outs[-1])
        times.append((time.perf_counter() - t0) / len(arg_sets))
    return TrialStats.from_times(times)


def benchmark_differential(
    make_fn: Callable[[int], tuple[Callable, tuple]],
    reps: int,
    trials: int = 7,
) -> TrialStats:
    """Per-iteration time via paired subtraction of two unroll depths.

    ``make_fn(r)`` returns ``(fn, args)`` where one ``fn(*args)`` call executes
    ``r`` iterations of the workload. The per-iteration estimate is
    ``(t(2 reps) - t(reps)) / reps`` per paired trial — this cancels the fixed
    per-dispatch cost, which dwarfs microsecond kernels and would otherwise be
    what the sweep measures.
    """
    fn_a, args_a = make_fn(reps)
    fn_b, args_b = make_fn(2 * reps)
    jax.block_until_ready(fn_a(*args_a))
    jax.block_until_ready(fn_b(*args_b))
    diffs = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn_a(*args_a))
        ta = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn_b(*args_b))
        tb = time.perf_counter() - t0
        diffs.append(max(tb - ta, 0.0) / reps)
    return TrialStats.from_times(diffs)


"""Harness + reduction tests (CPU backend).

Mirrors the reference's reduction unit tests (`/root/reference/test/reduction.jl`:
complex-ones input must reduce to exactly ``num_samples``) and exercises the
dict-driven benchmark entry points end to end on tiny configs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from gpuacceleratedtracking_tpu.bench import (
    collect_results,
    dict_list,
    eval_results,
    run_kernel_benchmark,
    run_reduction_benchmark,
    run_replica_benchmark,
    run_sweep,
    run_track_benchmark,
    savename,
)
from gpuacceleratedtracking_tpu.ops.reduce import REDUCTIONS, get_reduction


class TestReductions:
    @pytest.mark.parametrize("name", sorted(REDUCTIONS))
    def test_ones_reduce_to_num_samples(self, name):
        # The reference's golden reduction test: re=1, im=0 input sums to N
        # exactly (`/root/reference/test/reduction.jl:1-84`).
        n, a, l = 2048, 4, 3
        prod_re = jnp.ones((n, a, l), jnp.float32)
        prod_im = jnp.zeros((n, a, l), jnp.float32)
        acc_re, acc_im = get_reduction(name)(prod_re, prod_im)
        assert acc_re.shape == (a, l)
        np.testing.assert_array_equal(np.asarray(acc_re), n)
        np.testing.assert_array_equal(np.asarray(acc_im), 0.0)

    @pytest.mark.parametrize("name", sorted(REDUCTIONS))
    def test_variants_agree(self, name):
        import jax

        k = jax.random.key(7)
        prod_re = jax.random.normal(k, (1024, 2, 3), jnp.float32)
        prod_im = jax.random.normal(jax.random.key(8), (1024, 2, 3), jnp.float32)
        want = get_reduction("cplx_multi")(prod_re, prod_im)
        got = get_reduction(name)(prod_re, prod_im)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-5)

    def test_unknown_name(self):
        with pytest.raises(KeyError):
            get_reduction("harris_6")


class TestHarness:
    def test_kernel_benchmark_smoke(self):
        res = run_kernel_benchmark(
            {
                "GNSS": "GPSL1",
                "num_samples": 2048,
                "num_ants": 1,
                "num_correlators": 3,
                "algorithm": "fused_xla",
                "processor": "CPU",
                "reps": 2,
                "trials": 2,
            }
        )
        assert res["Minimum"] >= 0  # differential timing may clamp to 0
        assert res["Minimum"] <= res["Maximum"]
        assert res["samples_per_s"] > 0
        assert res["backend"] == "cpu"
        assert "realtime_ratio" in res

    def test_reduction_benchmark_smoke(self):
        res = run_reduction_benchmark(
            {
                "num_samples": 1024,
                "num_ants": 2,
                "num_correlators": 3,
                "algorithm": "cplx_multi",
                "processor": "CPU",
                "reps": 2,
                "trials": 2,
            }
        )
        assert res["Minimum"] >= 0

    def test_track_benchmark_smoke(self):
        res = run_track_benchmark(
            {
                "GNSS": "GPSL1",
                "num_samples": 2048,
                "num_channels": 3,
                "algorithm": "xla_bank",
                "processor": "CPU",
                "blocks": 2,
                "trials": 2,
            }
        )
        assert res["Minimum"] >= 0
        assert res["realtime_channels"] >= 0
        assert res["algorithm"] == "xla_bank"

    def test_dual_track_benchmark_smoke(self):
        # Closed-loop L5 dual-component (data+pilot, 2K bank channels, NH
        # wipe-off + atan2 pilot closure live in the timed path).
        from gpuacceleratedtracking_tpu.bench import run_dual_track_benchmark

        res = run_dual_track_benchmark(
            {
                "GNSS": "GPSL5",
                "num_samples": 4096,
                "num_channels": 2,
                "algorithm": "xla_bank",
                "processor": "CPU",
                "blocks": 2,
                "trials": 2,
            }
        )
        assert res["Minimum"] >= 0
        assert res["bank_channels"] == 4
        assert res["realtime_channels"] >= 0

    def test_acquire_benchmark_smoke(self):
        from gpuacceleratedtracking_tpu.bench import run_acquire_benchmark

        res = run_acquire_benchmark(
            {
                "GNSS": "GPSL1",
                "num_samples": 2048,
                "num_prns": 2,
                "rounds": 2,
                "trials": 2,
            }
        )
        assert res["Minimum"] >= 0
        assert res["num_bins"] > 0
        assert res["algorithm"] == "pcps"

    def test_results_record_device(self):
        # Every result names the device its arrays lived on, as JAX reports
        # it; the default device is jax.devices()[0].
        import jax

        res = run_kernel_benchmark(
            {"GNSS": "GPSL1", "num_samples": 1024, "algorithm": "xla_bank",
             "reps": 1, "trials": 1}
        )
        dev = jax.devices()[0]
        assert res["platform"] == dev.platform
        assert res["device_kind"] == dev.device_kind
        assert res["device_count"] == len(jax.devices())
        assert res["processor"] == dev.platform.upper()

    def test_replica_benchmark_smoke(self):
        res = run_replica_benchmark(
            {
                "GNSS": "GPSL1",
                "num_samples": 2048,
                "algorithm": "quantized",
                "processor": "CPU",
                "reps": 2,
                "trials": 2,
            }
        )
        assert res["Minimum"] >= 0


class TestSweep:
    def test_dict_list_expansion(self):
        configs = dict_list({"a": [1, 2], "b": ["x", "y"], "c": 7})
        assert len(configs) == 4
        assert all(c["c"] == 7 for c in configs)
        assert {(c["a"], c["b"]) for c in configs} == {
            (1, "x"), (1, "y"), (2, "x"), (2, "y")
        }

    def test_run_sweep_resume(self, tmp_path):
        calls = []

        def runner(config):
            calls.append(config["n"])
            return {"n": config["n"], "Minimum": 1.0}

        params = {"n": [1, 2, 3]}
        paths = run_sweep(params, runner, tmp_path, prefix="T", progress=False)
        assert len(paths) == 3 and all(p.exists() for p in paths)
        assert calls == [1, 2, 3]
        # Resume: nothing re-runs.
        run_sweep(params, runner, tmp_path, prefix="T", progress=False)
        assert calls == [1, 2, 3]
        # Saved JSON round-trips.
        assert json.loads(paths[0].read_text())["n"] == 1

    def test_collect_and_eval(self, tmp_path):
        def runner(config):
            t = 1e-4 * config["num_samples"] / 2048
            return {
                "GNSS": "GPSL1",
                "algorithm": "fused_xla",
                "num_samples": config["num_samples"],
                "Minimum": t,
                "Median": t,
            }

        run_sweep(
            {"num_samples": [2048, 4096]}, runner, tmp_path, progress=False
        )
        df = collect_results(tmp_path)
        assert len(df) == 2
        summary = eval_results(df)
        assert "realtime_x" in summary.columns

    def test_savename_deterministic(self):
        a = savename("K", {"b": 1, "a": 2})
        b = savename("K", {"a": 2, "b": 1})
        assert a == b == "K_a=2_b=1.json"

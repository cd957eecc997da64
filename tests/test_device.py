"""Device guard, compile cache, the HLO reader, and a tiny CPU rehearsal of
every `chip_smoke.py` phase.

The phases run on the card at full width (``python chip_smoke.py``); here
each phase function runs at a size the CPU affords, through the plain XLA
bank and through the Triton kernel in interpret mode.
"""

import functools
import json

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from gpuacceleratedtracking_tpu import device
from gpuacceleratedtracking_tpu.bench.hlo import unfused_buffers


class TestDevice:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="no GPU"):
            device.require_gpu()

    def test_describe(self):
        info = device.describe()
        assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                        "count": len(jax.devices())}

    def test_chip_smoke_refuses_cpu_and_prints_no_result(self, capsys):
        with pytest.raises(RuntimeError, match="no GPU"):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_set_is_left_to_jax(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_env_unset_uses_checkout_dir(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = device.enable_compile_cache()
        assert got == str(device.CHECKOUT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert device.enable_compile_cache() == got     # fixed, not per call


class TestHLO:
    def test_unfused_buffers_reads_hlo_text(self):
        text = "\n".join([
            "HloModule m",
            "%fused_computation (p: f32[64,4096]) -> f32[64] {",
            "  %p = f32[64,4096]{1,0} parameter(0)",
            "  ROOT %r = f32[64]{0} reduce(%p), dimensions={1}",
            "}",
            "ENTRY %main (a: f32[64,4096]) -> f32[64] {",
            "  %a = f32[64,4096]{1,0} parameter(0)",
            "  %big = f32[64,4096]{1,0} multiply_fusion(%a)",
            "  %m = f32[64,4096]{1,0} fusion(%a), kind=kLoop, calls=%fused_computation",
            "  ROOT %s = f32[64]{0} fusion(%m), kind=kInput, calls=%fused_computation",
            "}",
        ])
        found = unfused_buffers(text, 64 * 4096)
        assert [name for _, name, _ in found] == ["big", "m"]
        assert unfused_buffers(text, 64 * 4096 + 1) == []

    def test_finds_materialised_planes_in_compiled_hlo(self):
        # correlate_unfused pins its stages with optimization barriers, so
        # its [N]-sized planes must show up as buffers between kernels.
        from gpuacceleratedtracking_tpu.models import GPSL1
        from gpuacceleratedtracking_tpu.ops import correlate_unfused

        system = GPSL1()
        n = 4096
        fn = jax.jit(functools.partial(
            correlate_unfused, sample_shifts=(-1, 0, 1),
            code_length=system.code_length))
        text = fn.lower(jnp.zeros(n), jnp.zeros(n), jnp.asarray(system.codes),
                        0, 1500.0, n / 1e-3, 0.0, system.code_frequency,
                        0.0).compile().as_text()
        assert len(unfused_buffers(text, n)) >= 2

    @pytest.mark.parametrize("algo", ["xla_bank", "triton_bank"])
    def test_bank_graph_has_no_matrix_product(self, algo):
        # The bank correlators sum in f32 on the vector units: no dot, so no
        # TF32 on the card, and no [K, L, N] tap stack.
        from gpuacceleratedtracking_tpu.models import GPSL1
        from gpuacceleratedtracking_tpu.ops import registry

        system = GPSL1()
        k, n = 8, 4096
        fn = jax.jit(functools.partial(
            registry.get(algo), sample_shifts=(-3, 0, 3),
            code_length=system.code_length, sampling_frequency=n / 1e-3))
        z = jnp.zeros(k)
        text = fn.trace(jnp.zeros(n), jnp.zeros(n), jnp.asarray(system.codes),
                        jnp.zeros(k, jnp.int32), z, carrier_phase=z,
                        code_frequency=z, code_phase=z,
                        ).lower(lowering_platforms=("cuda",)).as_text()
        assert "dot_general" not in text
        assert f"{k}x3x{n}x" not in text


class TestSmokePhases:
    """Each `chip_smoke.py` phase at a CPU size."""

    def test_golden(self, bank_algorithm):
        assert "1476" in chip_smoke.golden(banks=(bank_algorithm,))

    def test_chip_indices(self):
        chip_smoke.chip_indices()

    @pytest.mark.parametrize("system,n,ants,taps", [
        ("GPSL1", 4096, 1, 3), ("GPSL5", 16384, 4, 7)])
    def test_bank_parity(self, bank_algorithm, system, n, ants, taps):
        dev = chip_smoke.bank_parity(system, 8, n, ants, taps, channels=4,
                                     algorithm=bank_algorithm)
        assert dev < 1e-5

    def test_closed_loop_l1(self, bank_algorithm):
        chip_smoke.closed_loop_l1(16, 4096, 20, algorithm=bank_algorithm)

    def test_closed_loop_l5_dual(self):
        chip_smoke.closed_loop_l5_dual(4, 16384, 20, algorithm="xla_bank")

    def test_stream(self):
        chip_smoke.stream(8, 4096, 20, algorithm="xla_bank")

    def test_acquisition(self):
        chip_smoke.acquisition(4096, 8)

    def test_triton_vs_plain(self):
        assert chip_smoke.triton_vs_plain("GPSL1", 4, 4096, 1, 3,
                                          interpret=True) < 1e-5

    def test_check_raises(self):
        with pytest.raises(chip_smoke.SmokeError, match="boom"):
            chip_smoke.check(False, "boom")

    def test_shapes_are_the_flagship_cells(self):
        assert chip_smoke.SHAPES == {
            "L1 K=1024 N=2^15 M=1 L=3": ("GPSL1", 1024, 32768, 1, 3),
            "L1 K=1024 N=2^18 M=1 L=3": ("GPSL1", 1024, 262144, 1, 3),
            "L5 K=256 N=2^15 M=4 L=7": ("GPSL5", 256, 32768, 4, 7),
        }
        json.dumps(chip_smoke.SHAPES)

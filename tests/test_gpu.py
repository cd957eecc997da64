"""Tests of what runs only on the card: the Triton bank kernel compiled for
the GPU (there is no interpreter in that path) and the fusion of the GPU
tracking step. They skip on the CPU; on the card run

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu -p no:xdist
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.mark.parametrize("system,n,ants,taps", [
    ("GPSL1", 32768, 1, 3), ("GPSL5", 32768, 4, 7)])
def test_compiled_kernel_matches_plain_bank(gpu, system, n, ants, taps):
    import chip_smoke

    assert chip_smoke.triton_vs_plain(system, 64, n, ants, taps) < 1e-5


def test_tracking_step_writes_no_sample_planes(gpu):
    # With triton_bank, nothing of [K, N] size leaves a fusion or kernel.
    from gpuacceleratedtracking_tpu.bench.hlo import unfused_buffers
    from gpuacceleratedtracking_tpu.models import GPSL1
    from gpuacceleratedtracking_tpu.tracking import (
        TrackConfig, init_state, track_bank)

    system = GPSL1()
    k, n = 256, 32768
    config = TrackConfig.for_system(system, n / 1e-3, n,
                                    algorithm="triton_bank")
    states = init_state(np.arange(k) % 32)
    sig = jnp.zeros((2, n), jnp.float32)
    text = track_bank.lower(config, jnp.asarray(system.codes), states, sig,
                            sig).compile().as_text()
    assert unfused_buffers(text, k * n) == []

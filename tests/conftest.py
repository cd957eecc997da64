"""Test configuration: CPU backend with 8 virtual devices.

The reference's suite silently skips without a GPU
(`/root/reference/test/runtests.jl:11-14`) — a weakness SURVEY.md §4 flags and we
do not copy: the tests run on the CPU backend (the Pallas Triton kernel in
interpret mode) and multi-device logic runs against an 8-device virtual CPU
mesh via ``xla_force_host_platform_device_count``. ``jax.config.update`` runs
before any test touches a backend, so the CPU is used even where a GPU exists,
unless ``JAX_PLATFORMS`` names another platform. Tests that only the card can
run carry the ``gpu`` marker and skip on the CPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``.
"""

import functools
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture(params=["xla_bank", "triton_bank"])
def bank_algorithm(request):
    """A bank algorithm name for `TrackConfig`; the Triton kernel is
    registered in interpret mode under its own name for the CPU."""
    if request.param == "xla_bank":
        return "xla_bank"
    from gpuacceleratedtracking_tpu.ops import registry
    from gpuacceleratedtracking_tpu.ops.triton_bank import correlate_triton_bank

    name = "triton_bank_interpret"
    registry.register(
        name, functools.partial(correlate_triton_bank, interpret=True))
    registry.BANK_ALGORITHMS.add(name)
    return name

"""Correlator-algorithm registry — the `ALGODICT` equivalent.

The reference names its kernel variants through string->ID->value-type
dictionaries (`/root/reference/src/GPUAcceleratedTracking.jl:44-91`) so the
harness and tests can sweep algorithms by name. Here every implementation is a
callable with one uniform signature::

    fn(signal_re, signal_im, codes, prn,
       carrier_frequency, sampling_frequency, carrier_phase,
       code_frequency, code_phase,
       sample_shifts, code_length) -> (accum_re, accum_im)

``bank`` is the bank correlator for the platform JAX runs on: the Pallas
Triton kernel on the GPU, where it measured faster than the plain XLA bank
in every flagship shape (PERF.md), and ``xla_bank`` elsewhere. ``xla_bank``
stays the reference the kernel is checked against.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax

from . import correlate, triton_bank

ALGORITHMS: Dict[str, Callable] = {}


def register(name: str, fn: Callable) -> None:
    ALGORITHMS[name] = fn


def get(name: str) -> Callable:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise KeyError(
            f"Unknown correlator algorithm {name!r}; known: {sorted(ALGORITHMS)}"
        ) from None


def names() -> list[str]:
    return sorted(ALGORITHMS)


def correlate_bank(*args, **kwargs):
    """`triton_bank` on the GPU, `xla_bank` on any other backend."""
    if jax.default_backend() == "gpu":
        return triton_bank.correlate_triton_bank(*args, **kwargs)
    return correlate.correlate_xla_bank(*args, **kwargs)


register("fused_xla", correlate.correlate_fused)
register("unfused_xla", correlate.correlate_unfused)
register("xla_bank", correlate.correlate_xla_bank)
register("triton_bank", triton_bank.correlate_triton_bank)
register("bank", correlate_bank)

# Algorithms with the bank signature ([K]-array channel parameters and a
# shared front-end signal) -- the 3-D multi-satellite family.
BANK_ALGORITHMS = {"bank", "xla_bank", "triton_bank"}

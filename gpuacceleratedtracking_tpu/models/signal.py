"""Synthetic GNSS signal generation (device-side, jittable).

Capability equivalent of the reference's `gen_signal` family
(`/root/reference/src/gen_signal.jl:1-184`): BPSK code chips upsampled by the
fractional code phase, modulated onto a complex carrier, for 1-D ``[N]``,
2-D ``[A, N]`` (antennas) and 3-D ``[K, A, N]`` (satellites x antennas) blocks.

Reference semantics reproduced exactly (`gen_signal.jl:64-70`):

  code_phase[n]   = f_code / f_s * n + start_code_phase
  chip[n]         = codes[floor(code_phase[n]) mod code_length, prn]
  carrier[n]      = exp(i * (2*pi * f_carrier / f_s * n + start_carrier_phase))
  signal[..., n]  = chip[n] * carrier[n]            (identical across antennas)

Departures from the reference: the sample axis is **last** (row-major
contiguous), instead of Julia's column-major samples-first layout — the same
memory order, the idiomatic axis convention for each platform. Optional AWGN and a code-frequency override
support closed-loop tracking tests, which the reference delegates to
Tracking.jl.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .system import GNSSSystem


def upsample_code(
    codes: jax.Array,
    prn: jax.Array | int,
    num_samples: int,
    code_frequency,
    sampling_frequency,
    start_code_phase,
    code_length: int,
) -> jax.Array:
    """Fractional-phase code upsampling: ``chip[n] = codes[floor(phase_n) mod L, prn]``.

    ``prn`` is 0-based here (the reference is 1-based Julia,
    `gen_signal.jl:65`). Scalar ``prn`` gives ``[N]``; vector ``[K]`` gives ``[K, N]``.
    """
    # Same rebased f32 phase computation as the replica ops so signal chips and
    # correlator replicas agree bit-exactly at floor boundaries.
    from ..ops.replica import code_phase_steps

    phase = code_phase_steps(code_frequency, sampling_frequency, num_samples)
    phase = phase + jnp.float32(start_code_phase)
    chip_idx = jnp.mod(jnp.floor(phase).astype(jnp.int32), code_length)
    col = codes.T[prn] if isinstance(prn, (int, np.integer)) else jnp.take(codes.T, prn, axis=0)
    return jnp.take(col, chip_idx, axis=-1)


def gen_carrier(
    num_samples: int,
    carrier_frequency,
    sampling_frequency,
    start_carrier_phase,
) -> jax.Array:
    """Unit-amplitude complex carrier ``exp(i(2 pi f/fs n + phi0))`` as complex64."""
    n = jnp.arange(num_samples, dtype=jnp.float32)
    # Wrap the per-sample cycle count before the 2*pi multiply to keep f32 accuracy
    # at large N (the reference relies on f64 host ranges, `gen_signal.jl:66`).
    cycles = carrier_frequency / sampling_frequency * n + start_carrier_phase / (2 * jnp.pi)
    cycles = cycles - jnp.floor(cycles)
    theta = (2 * jnp.pi) * cycles
    return jax.lax.complex(jnp.cos(theta), jnp.sin(theta))


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_samples",
        "num_ants",
        "code_length",
    ),
)
def _gen_signal_impl(
    codes,
    prn,
    carrier_frequency,
    num_samples,
    num_ants,
    sampling_frequency,
    start_code_phase,
    start_carrier_phase,
    code_frequency,
    code_length,
    secondary_code=None,
    secondary_phase=0,
):
    chips = upsample_code(
        codes, prn, num_samples, code_frequency, sampling_frequency,
        start_code_phase, code_length,
    )
    if secondary_code is not None:
        # Overlay (e.g. L5 Neuman-Hofman) sign: one +/-1 per primary code
        # period, selected by the integer part of the code phase in periods.
        from ..ops.replica import code_phase_steps

        phase = code_phase_steps(
            code_frequency, sampling_frequency, num_samples
        ) + jnp.float32(start_code_phase)
        period = (
            jnp.floor(phase / code_length).astype(jnp.int32) + secondary_phase
        )
        sign = jnp.take(
            secondary_code, jnp.mod(period, secondary_code.shape[0]), axis=0
        )
        chips = chips * sign
    carrier = gen_carrier(
        num_samples, carrier_frequency, sampling_frequency, start_carrier_phase
    )
    signal = (chips * carrier).astype(jnp.complex64)
    if num_ants is not None:
        signal = jnp.broadcast_to(
            signal[..., None, :], signal.shape[:-1] + (num_ants, num_samples)
        )
    return signal


def gen_signal(
    system: GNSSSystem,
    prn,
    carrier_frequency: float,
    num_samples: int,
    *,
    num_ants: Optional[int] = None,
    duration: float = 1e-3,
    start_code_phase: float = 0.0,
    start_carrier_phase: float = 0.0,
    code_frequency: Optional[float] = None,
    noise_std: float = 0.0,
    key: Optional[jax.Array] = None,
    secondary_code=None,
    secondary_phase: int = 0,
):
    """Generate a synthetic GNSS signal block.

    Args:
      system: GNSS system descriptor (code table + constants).
      prn: 0-based PRN index — scalar for one satellite, int array ``[K]`` for a
        bank (the 3-D path of `gen_signal.jl:95-112`).
      carrier_frequency: IF + Doppler in Hz.
      num_samples: samples in the block; sampling frequency = num_samples/duration
        (`gen_signal.jl:11`).
      num_ants: if given, replicate across an antenna axis -> ``[.., A, N]``.
      code_frequency: chipping-rate override (nominal + code Doppler).
      noise_std: per-component AWGN sigma (0 = noiseless, like the reference).
      key: PRNG key, required when noise_std > 0.
      secondary_code: optional ``[S]`` +/-1 overlay (one sign per primary code
        period, e.g. ``system.secondary_code`` for L5 Neuman-Hofman); applied
        with starting period offset ``secondary_phase``.

    Returns:
      (signal, sampling_frequency): complex64 ``[N]``, ``[A, N]``, ``[K, N]`` or
      ``[K, A, N]``.
    """
    sampling_frequency = num_samples / duration
    prn_arr = prn if isinstance(prn, (int, np.integer)) else jnp.asarray(prn)
    signal = _gen_signal_impl(
        jnp.asarray(system.codes),
        prn_arr,
        float(carrier_frequency),
        int(num_samples),
        None if num_ants is None else int(num_ants),
        float(sampling_frequency),
        float(start_code_phase),
        float(start_carrier_phase),
        float(code_frequency if code_frequency is not None else system.code_frequency),
        int(system.code_length),
        None if secondary_code is None else jnp.asarray(secondary_code, jnp.float32),
        int(secondary_phase),
    )
    if noise_std > 0.0:
        if key is None:
            raise ValueError("noise_std > 0 requires a PRNG key")
        noise = jax.random.normal(key, signal.shape + (2,), dtype=jnp.float32)
        signal = signal + noise_std * jax.lax.complex(noise[..., 0], noise[..., 1])
    return signal, sampling_frequency


def gen_signal_mixed(
    system: GNSSSystem,
    prns,
    dopplers,
    num_samples: int,
    *,
    num_ants: Optional[int] = None,
    duration: float = 1e-3,
    start_code_phases=None,
    intermediate_frequency: float = 0.0,
    noise_std: float = 0.0,
    key: Optional[jax.Array] = None,
):
    """Sum of K Doppler-shifted satellite signals — one RF front-end stream.

    Each satellite's code rate is scaled coherently with its carrier Doppler
    (``1 + doppler/f_center``), the physical relation a closed tracking loop
    relies on. Returns ``(signal [.., N], sampling_frequency)``. The
    reference's 3-D generator keeps satellites separate
    (`/root/reference/src/gen_signal.jl:95-112`, for the 3-D kernel
    benchmark); use `gen_signal` with a ``[K]`` prn array for that layout.
    """
    prns = np.asarray(prns)
    dopplers = np.asarray(dopplers, np.float64)
    if start_code_phases is None:
        start_code_phases = np.zeros(len(prns))
    total = None
    for prn, dop, phi in zip(prns, dopplers, np.asarray(start_code_phases)):
        scale = 1.0 + dop / system.center_frequency
        s, fs = gen_signal(
            system, int(prn), intermediate_frequency + float(dop),
            num_samples, num_ants=num_ants, duration=duration,
            start_code_phase=float(phi),
            code_frequency=system.code_frequency * scale,
        )
        total = s if total is None else total + s
    if noise_std > 0.0:
        if key is None:
            raise ValueError("noise_std > 0 requires a PRNG key")
        noise = jax.random.normal(key, total.shape + (2,), dtype=jnp.float32)
        total = total + noise_std * jax.lax.complex(noise[..., 0], noise[..., 1])
    return total, num_samples / duration


def soa(signal: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Split complex64 into the structure-of-arrays (re, im) float32 planes.

    The kernels operate on separate planes, like the reference's
    `StructArray{ComplexF32}` layout (`gen_signal.jl:181-184`).
    """
    return jnp.real(signal), jnp.imag(signal)

"""Replica generation ops: carrier NCO and code-replica upsampling (XLA paths).

Capability equivalents of the reference's replica kernels
(`/root/reference/src/algorithms.jl:13-140`): the global-memory and
texture-memory `gen_code_replica_*_kernel!` variants and the carrier generation
embedded in `downconvert_and_correlate_kernel_*`. The capability behind the
texture path — cheap wrapped fractional-phase code lookup — is provided by
integer phase arithmetic (`floor` + `mod`) feeding a gather, and by a quantized fixed-point NCO variant reproducing the
texture-quantization error envelope studied in
`/root/reference/scripts/code_replica_experiment.jl`.

Layout: sample axis last. The replica carries a halo of ``span = max_shift -
min_shift`` extra samples so that every correlator tap is a static slice of one
replica (the reference's `num_samples + num_of_shifts` buffer,
`/root/reference/src/benchmarks.jl:353`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def precise_div(num, den):
    """f32 ``num / den`` robust to XLA's reciprocal-multiply lowering.

    XLA lowers an f32 divide by a RUNTIME operand to reciprocal-multiply on
    the CPU, off by 1-2 ulp even when the exact quotient is representable:
    Galileo E1's chip rate ``2046000 / 8184000 = 0.25`` computes as
    0.249999985 under jit — and with chip boundaries landing exactly on
    sample boundaries, a 1-ulp-low rate shifts EVERY boundary one whole
    sample late (eager mode divides in python f64 at trace time, hiding the
    bug outside jit). With a static python-float denominator the reciprocal
    splits into two f32 terms ``hi + lo`` (~2^-48 accurate), making
    ``num*hi + num*lo`` correctly rounded for all practical magnitudes.
    Traced denominators (rare) fall back to the plain divide.
    """
    if isinstance(den, (int, float, np.floating, np.integer)):
        inv = 1.0 / float(den)
        hi = np.float32(inv)
        lo = np.float32(inv - float(hi))
        num = jnp.asarray(num, jnp.float32)
        return num * hi + num * lo
    return jnp.asarray(num, jnp.float32) / jnp.asarray(den, jnp.float32)


def code_phase_steps(code_frequency, sampling_frequency, num_samples: int):
    """Per-sample code phases ``rho * n`` as f32, rebased for accuracy.

    Computes ``rho*n`` as ``rho*block_start + rho*offset`` with small offsets so
    f32 rounding stays below ~1e-4 chips even at N = 2**18.
    """
    rho = precise_div(code_frequency, sampling_frequency)
    n_hi = jnp.arange(0, num_samples, 128, dtype=jnp.float32)
    n_lo = jnp.arange(128, dtype=jnp.float32)
    # [num_rows, 128] -> flat [ceil(N/128)*128], truncated to N by caller's reshape
    phases = rho * n_hi[:, None] + rho * n_lo[None, :]
    return phases.reshape(-1)[:num_samples]


def gen_code_replica(
    codes: jax.Array,
    prn,
    code_frequency,
    sampling_frequency,
    start_code_phase,
    num_samples: int,
    min_shift: int,
    max_shift: int,
    code_length: int,
) -> jax.Array:
    """Upsampled +/-1 code replica with tap halo.

    Element ``r[j]`` holds the chip at sample index ``n = j + min_shift`` for
    ``j in [0, num_samples + span)``, ``span = max_shift - min_shift`` — the
    tap with shift ``d`` correlates sample ``n`` against ``r[n + d - min_shift]``
    (the reference's `code_replica[sample_idx + sample_shift]`,
    `/root/reference/src/algorithms.jl:585`).

    ``prn`` is 0-based; scalar or ``[K]`` (multi-satellite replica, the
    `gen_code_replica_texture_mem_strided_nsat_kernel!` analog,
    `/root/reference/src/algorithms.jl:78-98`).
    """
    # Main range n in [0, N + max_shift) reuses the signal generator's exact
    # phase grid (origin 0) so prompt-tap chips are bit-identical to the
    # transmitted chips; the left halo n in [min_shift, 0) is tiny and computed
    # directly.
    rho = precise_div(code_frequency, sampling_frequency)
    phase_main = code_phase_steps(
        code_frequency, sampling_frequency, num_samples + max_shift
    ) + jnp.float32(start_code_phase)
    if min_shift < 0:
        n_left = jnp.arange(min_shift, 0, dtype=jnp.float32)
        phase_left = rho * n_left + jnp.float32(start_code_phase)
        phase = jnp.concatenate([phase_left, phase_main])
    else:
        phase = phase_main[min_shift:]
    chip_idx = jnp.mod(jnp.floor(phase).astype(jnp.int32), code_length)
    cols = jnp.take(codes.T, jnp.asarray(prn), axis=0)  # [..K.., code_length]
    return jnp.take(cols, chip_idx, axis=-1)  # [..K.., N + span]


def gen_code_replica_quantized(
    codes: jax.Array,
    prn,
    code_frequency,
    sampling_frequency,
    start_code_phase,
    num_samples: int,
    min_shift: int,
    max_shift: int,
    code_length: int,
    phase_bits: int = 12,
) -> jax.Array:
    """Fixed-point-NCO replica: the counterpart of the texture-memory lookup.

    The reference's texture path quantizes the normalized fetch coordinate to the
    texture's 8.8 fixed-point interpolation grid (hardware wrap + nearest
    neighbour, `/root/reference/src/algorithms.jl:72`), trading exactness for
    speed; its code-phase error envelope is the subject of
    `scripts/code_replica_experiment.jl` (mean 0.03%, max 3.17%). Here the
    per-sample fractional code phase is quantized to ``phase_bits`` fractional
    bits before the floor, reproducing that accuracy/speed trade. The
    default 12 bits measures mean 0.006 % / max 0.02 % chip mismatch over the
    reference's N-sweep (scripts/code_replica_experiment.py) — 5x tighter
    than the reference texture path's mean 0.03 % / max 3.17 % — at identical
    speed (the quantization is one scale constant).
    """
    span = max_shift - min_shift
    total = num_samples + span
    scale = jnp.float32(2**phase_bits)
    phase = code_phase_steps(code_frequency, sampling_frequency, total)
    phase = phase + (
        jnp.float32(start_code_phase)
        + jnp.float32(code_frequency / sampling_frequency) * jnp.float32(min_shift)
    )
    # Round-to-nearest on the fixed-point grid, matching the texture unit's
    # nearest-neighbour coordinate snap (a floor here could never cross a chip
    # boundary and would be error-free by construction).
    q = jnp.round(phase * scale) / scale
    chip_idx = jnp.mod(jnp.floor(q).astype(jnp.int32), code_length)
    cols = jnp.take(codes.T, jnp.asarray(prn), axis=0)
    return jnp.take(cols, chip_idx, axis=-1)


def gen_carrier_replica(
    carrier_frequency,
    sampling_frequency,
    start_carrier_phase_rad,
    num_samples: int,
) -> tuple[jax.Array, jax.Array]:
    """(cos, sin) planes of ``exp(i(2 pi f/fs n + phi))`` — the per-sample
    `CUDA.sincos` of the reference (`/root/reference/src/algorithms.jl:573`),
    vectorized with phase wrapping for f32 accuracy."""
    f_cyc = jnp.float32(carrier_frequency / sampling_frequency)
    phi_cyc = jnp.float32(start_carrier_phase_rad) / jnp.float32(2 * jnp.pi)
    n_hi = jnp.arange(0, num_samples + 127, 128, dtype=jnp.float32)[:, None]
    n_lo = jnp.arange(128, dtype=jnp.float32)[None, :]
    cyc_hi = f_cyc * n_hi
    cyc_hi = cyc_hi - jnp.floor(cyc_hi)  # wrap the large part
    cyc = cyc_hi + f_cyc * n_lo + phi_cyc
    theta = jnp.float32(2 * jnp.pi) * (cyc - jnp.floor(cyc))
    cos = jnp.cos(theta).reshape(-1)[:num_samples]
    sin = jnp.sin(theta).reshape(-1)[:num_samples]
    return cos, sin

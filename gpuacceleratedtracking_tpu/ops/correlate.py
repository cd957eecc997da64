"""XLA correlation paths: downconvert (carrier wipe-off) + EPL accumulation.

These are the compiler-scheduled implementations — the oracle for the Pallas
kernel and the counterpart of the reference's CUDA pipeline zoo
(`/root/reference/src/algorithms.jl:142-866` and the dispatchers at
`:869-1545`). Where CUDA forced ten hand-fused variants, XLA fusion collapses
the design space to:

- ``correlate_fused``  — one channel, one jitted graph: carrier NCO, wipe-off,
  code replica and tap MACs (the 1330/1331/1431 "fully fused" family).
- ``correlate_unfused`` — materializes carrier replica, downconverted signal and
  per-sample products in device memory (the 2330..2431 family), kept for
  benchmarking the fusion win, like the reference keeps its algorithm-2
  pipelines.
- ``correlate_xla_bank`` — K channels against one shared signal (the 3-D
  multi-satellite family), with the chip arithmetic the Triton kernel shares.

In ``correlate_fused`` the tap MAC is a ``[L, N] x [N, A]`` contraction with
f32 accumulation at ``Precision.HIGHEST`` (on the GPU a float32 product
without it may run in TF32) — the role of the Harris shared-memory f32 trees
(`/root/reference/src/reduction.jl`).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import replica as replica_ops


def downconvert(
    signal_re: jax.Array,
    signal_im: jax.Array,
    carrier_cos: jax.Array,
    carrier_sin: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Carrier wipe-off: ``dw = signal * conj(carrier)``, SoA planes.

    Matches `/root/reference/src/algorithms.jl:577-578`:
    ``dw_re = s_re*c + s_im*s;  dw_im = s_im*c - s_re*s``.
    Broadcasts carrier ``[N]`` over any leading antenna axes of the signal.
    """
    dw_re = signal_re * carrier_cos + signal_im * carrier_sin
    dw_im = signal_im * carrier_cos - signal_re * carrier_sin
    return dw_re, dw_im


def _tap_matrix(code_replica: jax.Array, sample_shifts: Sequence[int], num_samples: int):
    """Stack tap views of the haloed replica into ``[L, N]`` (static slices)."""
    d0 = int(min(sample_shifts))
    return jnp.stack(
        [
            jax.lax.dynamic_slice_in_dim(
                code_replica, int(d) - d0, num_samples, axis=-1
            )
            for d in sample_shifts
        ],
        axis=-2,
    )


def epl_accumulate(
    dw_re: jax.Array,
    dw_im: jax.Array,
    code_replica: jax.Array,
    sample_shifts: Sequence[int],
) -> tuple[jax.Array, jax.Array]:
    """Tap-shifted MAC: ``accum[a, l] = sum_n dw[a, n] * replica[n + d_l - d_min]``.

    ``dw_*``: ``[..., A, N]`` or ``[..., N]``; returns ``[..., A, L]`` /
    ``[..., L]``. The contraction accumulates in f32 at ``HIGHEST``.
    """
    num_samples = dw_re.shape[-1]
    taps = _tap_matrix(code_replica, sample_shifts, num_samples)  # [..., L, N]

    def contract(x):
        if taps.ndim == 2 and x.ndim == 1:
            lhs, out_squeeze = x[None, :], True
        else:
            lhs, out_squeeze = x, False
        acc = jnp.einsum(
            "...an,...ln->...al",
            lhs,
            taps,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return acc[0] if out_squeeze else acc

    return contract(dw_re), contract(dw_im)


def correlate_fused(
    signal_re: jax.Array,
    signal_im: jax.Array,
    codes: jax.Array,
    prn,
    carrier_frequency,
    sampling_frequency,
    carrier_phase,
    code_frequency,
    code_phase,
    sample_shifts: Sequence[int],
    code_length: int,
) -> tuple[jax.Array, jax.Array]:
    """Single-channel fused downconvert+correlate (XLA-fused 1330-family analog).

    ``signal_*``: ``[N]`` or ``[A, N]``. Returns ``(accum_re, accum_im)`` of shape
    ``[L]`` / ``[A, L]``. All replica generation happens inside the graph.
    """
    num_samples = signal_re.shape[-1]
    cos, sin = replica_ops.gen_carrier_replica(
        carrier_frequency, sampling_frequency, carrier_phase, num_samples
    )
    dw_re, dw_im = downconvert(signal_re, signal_im, cos, sin)
    code_rep = replica_ops.gen_code_replica(
        codes,
        prn,
        code_frequency,
        sampling_frequency,
        code_phase,
        num_samples,
        int(min(sample_shifts)),
        int(max(sample_shifts)),
        code_length,
    )
    return epl_accumulate(dw_re, dw_im, code_rep, sample_shifts)


def _top12(x):
    """``x`` with all but its top 12 significant bits cleared (f32)."""
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32), jnp.int32)
    return jax.lax.bitcast_convert_type(bits & ~0xFFF, jnp.float32)


def code_nco_terms(code_frequency, sampling_frequency, code_phase):
    """Per-channel code-NCO terms for `chip_from_terms`, from ``[K]`` inputs.

    The chip rate ``rho = f_code / fs`` comes out as ``rho_hi`` (12
    significant bits) plus ``rho_lo``, together good to ~2^-36 of ``rho``:
    ``f_code`` and ``1/fs`` (``fs`` a static Python number) are cut into
    12-bit pieces whose products are exact in f32. The start phase is split into integer
    and fractional chips. Then ``rho_hi * m_hi`` is exact for every ``m_hi``
    that is a multiple of 128 below 2^19, and what is left in f32 stays below
    ~100 chips, so chip boundaries land within ~1e-5 chips of float64 at
    every sample. One f32 ``rho * m`` near ``code_length`` (10230 chips for
    GPS L5) would be off by up to 1e-3 chips.
    """
    f_code = jnp.asarray(code_frequency, jnp.float32)
    inv = 1.0 / float(sampling_frequency)
    pieces = []
    for _ in range(3):
        piece = np.float32(inv)
        piece = np.int32(piece.view(np.int32) & ~0xFFF).view(np.float32)
        pieces.append(piece)
        inv -= float(piece)
    i1, i2, i3 = pieces
    a1 = _top12(f_code)
    a2 = f_code - a1
    t1 = a1 * i1                                # exact
    rho_hi = _top12(t1)
    rho_lo = (t1 - rho_hi) + ((a1 * i2 + a2 * i1) + (a1 * i3 + a2 * i2))
    phi = jnp.asarray(code_phase, jnp.float32)
    phi_int = jnp.floor(phi)
    return (rho_hi, rho_lo, rho_hi + rho_lo, phi_int.astype(jnp.int32),
            phi - phi_int)


def chip_from_terms(terms, sample_index, code_length: int):
    """Chip index at int32 sample index ``m`` (broadcasting) from
    `code_nco_terms`: ``floor(rho * m + phi) mod code_length``."""
    rho_hi, rho_lo, rho, phi_int, phi_frac = terms
    m_lo = sample_index % 128
    m_hi = (sample_index - m_lo).astype(jnp.float32)
    whole = rho_hi * m_hi                       # exact
    whole_int = jnp.floor(whole)
    frac = (whole - whole_int) + rho_lo * m_hi + rho * m_lo.astype(jnp.float32)
    frac = frac + phi_frac
    chip = whole_int.astype(jnp.int32) + phi_int + jnp.floor(frac).astype(jnp.int32)
    return chip % code_length


def bank_chip_index(
    code_frequency: jax.Array,
    sampling_frequency: float,
    code_phase: jax.Array,
    sample_index: jax.Array,
    code_length: int,
) -> jax.Array:
    """Chip indices ``[K, *S]`` of ``[K]`` channels at int32 samples ``S``."""
    lead = (-1,) + (1,) * sample_index.ndim
    terms = [t.reshape(lead) for t in code_nco_terms(
        code_frequency, sampling_frequency, code_phase)]
    return chip_from_terms(terms, sample_index, code_length)


def bank_carrier(
    carrier_frequency: jax.Array,
    sampling_frequency: float,
    carrier_phase: jax.Array,
    num_samples: int,
) -> tuple[jax.Array, jax.Array]:
    """``[K, N]`` (cos, sin) planes on `replica.gen_carrier_replica`'s grid."""
    f_cyc = (carrier_frequency / sampling_frequency).astype(jnp.float32)[:, None]
    phi_cyc = (carrier_phase / jnp.float32(2 * jnp.pi))[:, None]
    n = jnp.arange(num_samples, dtype=jnp.int32)
    n_lo = n % 128
    cyc_hi = f_cyc * (n - n_lo).astype(jnp.float32)
    cyc_hi = cyc_hi - jnp.floor(cyc_hi)
    cyc = cyc_hi + f_cyc * n_lo.astype(jnp.float32) + phi_cyc
    theta = jnp.float32(2 * jnp.pi) * (cyc - jnp.floor(cyc))
    return jnp.cos(theta), jnp.sin(theta)


def correlate_xla_bank(
    signal_re: jax.Array,
    signal_im: jax.Array,
    codes: jax.Array,
    prn: jax.Array,
    carrier_frequency: jax.Array,
    sampling_frequency,
    carrier_phase: jax.Array,
    code_frequency: jax.Array,
    code_phase: jax.Array,
    sample_shifts: Sequence[int],
    code_length: int,
) -> tuple[jax.Array, jax.Array]:
    """Bank correlator: ``[K]`` channel parameters against one shared signal.

    The multi-satellite correlator of the reference's 3-D kernels
    (`/root/reference/src/algorithms.jl:637-718`) in plain XLA: per-sample
    carrier planes, one chip gather per tap from the flat ``[code_length *
    P]`` code table, wipe-off, and one f32 ``jnp.sum`` per tap and
    component. No matrix product, so nothing runs in TF32. On the GPU, XLA
    writes the ``[K, (A,) N]`` wipe-off planes once and fuses each tap's
    gather into its reduction; forms that keep every ``[K, N]`` value inside
    one fusion recompute the carrier per reduction and measured slower
    (PERF.md). ``signal_*``: ``[N]`` or ``[A, N]``; returns ``[K, L]`` /
    ``[K, A, L]``. Scalar channel parameters give ``[L]`` / ``[A, L]``, so
    the bank path also serves single-channel tracking.
    """
    params = [jnp.asarray(x) for x in (
        prn, carrier_frequency, carrier_phase, code_frequency, code_phase)]
    scalar = params[0].ndim == 0
    prn, f_car, phi_car, f_code, phi_code = (
        jnp.atleast_1d(x) for x in params)
    f_car, phi_car, f_code, phi_code = (
        x.astype(jnp.float32) for x in (f_car, phi_car, f_code, phi_code))
    num_samples = signal_re.shape[-1]
    cos, sin = bank_carrier(f_car, sampling_frequency, phi_car, num_samples)
    if signal_re.ndim == 2:                       # [A, N] -> [K, A, N]
        cos, sin = cos[:, None, :], sin[:, None, :]
    dw_re, dw_im = downconvert(signal_re, signal_im, cos, sin)

    table = jnp.asarray(codes, jnp.float32).reshape(-1)   # [code_length * P]
    n = jnp.arange(num_samples, dtype=jnp.int32)
    offset = prn.astype(jnp.int32)[:, None]
    acc_re, acc_im = [], []
    for d in sample_shifts:
        chip = bank_chip_index(
            f_code, sampling_frequency, phi_code, n + int(d), code_length)
        rep = table.at[chip * codes.shape[-1] + offset].get(
            mode="promise_in_bounds")
        if signal_re.ndim == 2:
            rep = rep[:, None, :]
        acc_re.append(jnp.sum(dw_re * rep, axis=-1))
        acc_im.append(jnp.sum(dw_im * rep, axis=-1))
    are, aim = jnp.stack(acc_re, axis=-1), jnp.stack(acc_im, axis=-1)
    return (are[0], aim[0]) if scalar else (are, aim)


def correlate_unfused(
    signal_re: jax.Array,
    signal_im: jax.Array,
    codes: jax.Array,
    prn,
    carrier_frequency,
    sampling_frequency,
    carrier_phase,
    code_frequency,
    code_phase,
    sample_shifts: Sequence[int],
    code_length: int,
) -> tuple[jax.Array, jax.Array]:
    """Unfused pipeline with materialized intermediates (2330-family analog).

    Stage boundaries are pinned with `jax.lax.optimization_barrier` so XLA cannot
    re-fuse them — each stage round-trips device memory like the reference's
    `downconvert_and_accumulate_strided_kernel!` writing carrier, downconverted
    signal and per-sample products to global memory
    (`/root/reference/src/algorithms.jl:828-866`).
    """
    num_samples = signal_re.shape[-1]
    cos, sin = replica_ops.gen_carrier_replica(
        carrier_frequency, sampling_frequency, carrier_phase, num_samples
    )
    cos, sin = jax.lax.optimization_barrier((cos, sin))
    code_rep = replica_ops.gen_code_replica(
        codes, prn, code_frequency, sampling_frequency, code_phase,
        num_samples, int(min(sample_shifts)), int(max(sample_shifts)), code_length,
    )
    code_rep = jax.lax.optimization_barrier(code_rep)
    dw_re, dw_im = downconvert(signal_re, signal_im, cos, sin)
    dw_re, dw_im = jax.lax.optimization_barrier((dw_re, dw_im))
    taps = _tap_matrix(code_rep, sample_shifts, num_samples)
    # Materialized per-sample products [..., L, N] (the reference's `accum` array),
    # then a separate reduction pass.
    prod_re = dw_re[..., None, :] * taps
    prod_im = dw_im[..., None, :] * taps
    prod_re, prod_im = jax.lax.optimization_barrier((prod_re, prod_im))
    return jnp.sum(prod_re, axis=-1), jnp.sum(prod_im, axis=-1)

"""PCPS acquisition: FFT-based parallel code-phase search.

The reference benchmarks tracking only; its ecosystem's acquisition
(Acquisition.jl, feeding `TrackingState` — see the reference's CPU baseline
construction at `/root/reference/src/benchmarks.jl:54`) is re-provided here
so a user can run the full cold-start -> track pipeline on the device:

- circular correlation over all code phases at once via ``FFT * conj(FFT)``
  with `jnp.fft` (cuFFT on the GPU),
- Doppler bins batched with `lax.map` over a vmapped kernel so device memory
  use is bounded at ``bin_batch x K x N`` complex words,
- K satellites searched simultaneously (the code-table FFT is one batched FFT).

Outputs hand off directly to `tracking.init_state` (0-based PRNs, Doppler in
Hz, code phase in chips).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.signal import upsample_code
from ..models.system import GNSSSystem


def _fft_pair(re, im, inverse: bool = False):
    """(I)DFT over the last axis on split re/im planes."""
    z = jax.lax.complex(re, im)
    z = jnp.fft.ifft(z) if inverse else jnp.fft.fft(z)
    return jnp.real(z), jnp.imag(z)


class AcquisitionResult(NamedTuple):
    """Per-satellite acquisition estimates (leading axis = searched PRNs)."""

    prn: jnp.ndarray              # int32, 0-based (as searched)
    carrier_doppler: jnp.ndarray  # Hz, best bin
    code_phase: jnp.ndarray       # chips, in [0, code_length)
    peak_metric: jnp.ndarray      # deflection: (peak - mu) / sigma off-peak
    power: jnp.ndarray            # raw peak power


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_samples", "code_length", "num_bins", "bin_batch",
    ),
)
def _pcps_impl(
    signal_re, signal_im, code_fft_re, code_fft_im, dopplers,
    sampling_frequency, intermediate_frequency, code_frequency, num_samples,
    code_length, num_bins, bin_batch,
):
    n = jnp.arange(num_samples, dtype=jnp.float32)
    # Noncoherent integration: ``signal_*`` may carry a leading rounds axis
    # [R, N]; per-round correlation powers are summed (phase-insensitive, so
    # data-bit flips between rounds don't cancel the peak).
    if signal_re.ndim == 1:
        signal_re, signal_im = signal_re[None, :], signal_im[None, :]

    def one_bin(doppler):
        f = (intermediate_frequency + doppler) / sampling_frequency
        cyc = f * n
        cyc = cyc - jnp.floor(cyc)
        theta = (2 * jnp.pi) * cyc
        c, s = jnp.cos(theta), jnp.sin(theta)
        # Wipe-off: sig * conj(carrier).
        mr = signal_re * c[None, :] + signal_im * s[None, :]
        mi = signal_im * c[None, :] - signal_re * s[None, :]
        sr, si = _fft_pair(mr, mi)                 # [R, N]
        # S * conj(C) per satellite.
        pr = sr[:, None, :] * code_fft_re[None] + si[:, None, :] * code_fft_im[None]
        pi = si[:, None, :] * code_fft_re[None] - sr[:, None, :] * code_fft_im[None]
        qr, qi = _fft_pair(pr, pi, inverse=True)   # [R, K, N]
        return jnp.sum(qr * qr + qi * qi, axis=0)            # [K, N]

    # lax.map over bin batches bounds memory to [bin_batch, K, N].
    pad_bins = (num_bins + bin_batch - 1) // bin_batch * bin_batch
    dops = jnp.pad(dopplers, (0, pad_bins - num_bins), mode="edge")
    power = jax.lax.map(
        jax.vmap(one_bin), dops.reshape(-1, bin_batch)
    )                                                   # [B/bb, bb, K, N]
    power = power.reshape(pad_bins, *power.shape[2:])[:num_bins]  # [D, K, N]

    # Peak over (doppler, phase) per satellite.
    k = power.shape[1]
    flat = power.transpose(1, 0, 2).reshape(k, -1)      # [K, D*N]
    idx = jnp.argmax(flat, axis=1)
    peak = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    bin_idx = idx // num_samples
    phase_idx = idx % num_samples

    # Detection statistic: deflection coefficient (peak - mu) / sigma over
    # the off-peak cells of the winning Doppler plane (guard of +/-1 chip
    # around the peak). Unlike peak/mean, this captures noncoherent gain:
    # summing R rounds shrinks the floor's relative sigma by sqrt(R).
    samples_per_chip = sampling_frequency / code_frequency
    guard = jnp.ceil(samples_per_chip).astype(jnp.int32)
    pos = jnp.arange(num_samples)[None, :]
    dist = jnp.abs(pos - phase_idx[:, None])
    dist = jnp.minimum(dist, num_samples - dist)
    mask = (dist > guard).astype(jnp.float32)           # [K, N]
    best_plane = jnp.take_along_axis(
        power, bin_idx[None, :, None], axis=0
    )[0]                                                # [K, N]
    denom = jnp.maximum(jnp.sum(mask, axis=1), 1)
    mu = jnp.sum(best_plane * mask, axis=1) / denom
    var = jnp.sum((best_plane - mu[:, None]) ** 2 * mask, axis=1) / denom
    metric = (peak - mu) / jnp.maximum(jnp.sqrt(var), 1e-30)

    code_phase = (
        phase_idx.astype(jnp.float32) * (code_frequency / sampling_frequency)
    ) % code_length
    # Tracking replicas start at this shift into the code: the signal's code
    # phase at sample 0 is (code_length - shift) mod code_length.
    code_phase = (code_length - code_phase) % code_length
    doppler = dopplers[bin_idx]
    return doppler, code_phase, metric, peak


def acquire(
    system: GNSSSystem,
    signal_re: jax.Array,
    signal_im: jax.Array,
    prns,
    sampling_frequency: float,
    *,
    intermediate_frequency: float = 0.0,
    max_doppler: float = 5000.0,
    doppler_step: Optional[float] = None,
    bin_batch: int = 8,
) -> AcquisitionResult:
    """Search ``prns`` (0-based) in a signal block over a Doppler grid.

    ``signal_*``: ``[N]`` f32 planes (one antenna; beamform upstream if
    needed), or ``[R, N]`` for R-round **noncoherent integration** — per-round
    correlation powers are summed, so data-bit sign flips between rounds
    don't cancel; rounds should be consecutive blocks of one code period
    each (code phase then aligns across rounds up to Doppler drift).
    ``doppler_step`` defaults to ``2/(3 T)`` — the standard 2/3-bin spacing
    for coherent integration time ``T = N / fs``. Returns estimates aligned
    with ``prns``; ``peak_metric`` is the deflection coefficient
    ``(peak - mu)/sigma`` of the winning Doppler plane — the noise-only
    maximum over the search grid sits near ``sqrt(2 ln(D N))`` (~5), so
    accept at roughly > 8; noncoherent rounds raise it by ~sqrt(R).
    """
    num_samples = signal_re.shape[-1]
    t = num_samples / sampling_frequency
    if doppler_step is None:
        doppler_step = 2.0 / (3.0 * t)
    num_bins = int(2 * max_doppler / doppler_step) + 1
    dopplers = jnp.linspace(
        -max_doppler, max_doppler, num_bins
    ).astype(jnp.float32)

    prns = jnp.asarray(prns, jnp.int32)
    chips = upsample_code(
        jnp.asarray(system.codes), prns, num_samples, system.code_frequency,
        sampling_frequency, 0.0, system.code_length,
    )                                                   # [K, N]
    cf_re, cf_im = _fft_pair(
        chips.astype(jnp.float32), jnp.zeros_like(chips, jnp.float32)
    )

    doppler, code_phase, metric, peak = _pcps_impl(
        signal_re, signal_im, cf_re, cf_im, dopplers,
        float(sampling_frequency), float(intermediate_frequency),
        float(system.code_frequency), int(num_samples),
        int(system.code_length), int(num_bins), int(bin_batch),
    )
    return AcquisitionResult(
        prn=prns, carrier_doppler=doppler, code_phase=code_phase,
        peak_metric=metric, power=peak,
    )


def to_track_states(result: AcquisitionResult, cn0_window: int = 20):
    """Acquisition -> tracking handoff: build a seeded channel-bank state."""
    from ..tracking.state import init_state

    return init_state(
        np.asarray(result.prn),
        carrier_doppler=np.asarray(result.carrier_doppler),
        code_phase=np.asarray(result.code_phase),
        cn0_window=cn0_window,
    )

"""Float64 NumPy reference correlator, written independently of the JAX ops.

The correctness check shared by the tests and the card's smoke run: the same
carrier wipe-off and tap-shifted code MAC as the device paths, in float64
with per-sample ``floor`` chip indices and no phase grid tricks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def chip_index(code_frequency, sampling_frequency, code_phase, sample_index,
               code_length: int) -> np.ndarray:
    """Chip index ``floor(f_code / fs * n + phi) mod code_length`` in f64."""
    n = np.asarray(sample_index, np.float64)
    phase = float(code_frequency) / float(sampling_frequency) * n + float(code_phase)
    return np.mod(np.floor(phase).astype(np.int64), code_length)


def correlate(signal, codes, prn: int, carrier_frequency, sampling_frequency,
              carrier_phase, code_frequency, code_phase,
              shifts: Sequence[int]) -> np.ndarray:
    """EPL accumulators of one channel: complex ``[..., L]``.

    ``signal``: complex ``[N]`` or ``[A, N]``; ``codes``: ``[code_length,
    P]`` chips; frequencies in Hz, phases in rad (carrier) and chips (code).
    """
    signal = np.asarray(signal).astype(np.complex128)
    codes = np.asarray(codes)
    num_samples = signal.shape[-1]
    n = np.arange(num_samples, dtype=np.float64)
    carrier = np.exp(1j * (2 * np.pi * float(carrier_frequency)
                           / float(sampling_frequency) * n
                           + float(carrier_phase)))
    dw = signal * np.conj(carrier)
    out = []
    for d in shifts:
        idx = chip_index(code_frequency, sampling_frequency, code_phase,
                         n + d, codes.shape[0])
        out.append(np.sum(dw * codes[idx, prn].astype(np.float64), axis=-1))
    return np.stack(out, axis=-1)

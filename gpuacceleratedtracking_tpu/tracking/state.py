"""Tracking state and configuration.

The Tracking.jl `TrackingState` role (the reference builds one for its CPU
baseline, `/root/reference/src/benchmarks.jl:54`), as a JAX pytree that lives
on device across `lax.scan` steps — loop closure without host round-trips
(SURVEY.md §7 step 4).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..models.correlator import EPLCorrelator, correlator_sample_shifts
from ..models.system import GNSSSystem
from . import cn0 as cn0_mod
from .loop_filter import LoopFilterState
from . import loop_filter


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static (hashable) per-channel-bank tracking configuration."""

    code_frequency: float
    code_length: int
    center_frequency: float
    sampling_frequency: float
    num_samples: int                    # samples per integration block
    intermediate_frequency: float = 0.0
    sample_shifts: tuple = (-1, 0, 1)
    pll_bandwidth: float = 18.0
    pll_order: int = 3
    dll_bandwidth: float = 1.0
    dll_order: int = 2
    fll_bandwidth: float = 4.0   # 0 disables the FLL assist
    cn0_window: int = 20
    algorithm: str = "bank"
    # Secondary (overlay) code wipe-off: +/-1 signs, one per integration
    # block (e.g. L5 Neuman-Hofman, one sign per 1 ms primary period).
    # Indexed by the channel's ms_elapsed — align with `init_state`'s
    # ``ms_elapsed`` after secondary-code sync (`tracking.secondary`).
    secondary_code: tuple = ()
    # PLL discriminator: "costas" (data-tolerant, default) or "atan2"
    # (full-range four-quadrant, for dataless pilot components).
    pll_discriminator: str = "costas"
    # Coherent post-integration: accumulate the (overlay-wiped) accumulators
    # over this many consecutive blocks before each discriminator/filter
    # update (the Tracking.jl extended-integration role). Extends coherent
    # SNR by ~10*log10(k) dB for weak signals; requires overlay alignment
    # (secondary sync) so block signs are consistent. NCO phases still
    # advance every block; the loop closes once per window with
    # integration time k * t.
    coherent_blocks: int = 1

    @classmethod
    def for_system(
        cls,
        system: GNSSSystem,
        sampling_frequency: float,
        num_samples: Optional[int] = None,
        num_correlators: int = 3,
        preferred_code_shift: float = 0.5,
        use_secondary: bool = True,
        **kwargs,
    ) -> "TrackConfig":
        if num_samples is None:
            num_samples = round(sampling_frequency * 1e-3)
        shifts = correlator_sample_shifts(
            system,
            EPLCorrelator(num_correlators),
            sampling_frequency,
            preferred_code_shift,
        )
        # Auto-enable secondary-code wipe-off when the system has an overlay
        # and the primary code period is an integer number of integration
        # blocks: one overlay sign per period, repeated per block (m = 1 for
        # L5 NH over 1 ms blocks; m = 4 for Galileo E1-C CS25 over its 4 ms
        # primary period tracked with 1 ms blocks).
        if (
            use_secondary
            and system.secondary_code is not None
            and "secondary_code" not in kwargs
        ):
            period = system.code_length / system.code_frequency
            block = num_samples / sampling_frequency
            m = period / block
            if abs(m - round(m)) < 1e-6 and round(m) >= 1:
                kwargs["secondary_code"] = tuple(
                    float(s)
                    for s in np.repeat(
                        np.asarray(system.secondary_code), round(m)
                    )
                )
        return cls(
            code_frequency=system.code_frequency,
            code_length=system.code_length,
            center_frequency=system.center_frequency,
            sampling_frequency=sampling_frequency,
            num_samples=int(num_samples),
            sample_shifts=tuple(int(s) for s in shifts),
            **kwargs,
        )

    @property
    def integration_time(self) -> float:
        return self.num_samples / self.sampling_frequency

    @property
    def prompt_index(self) -> int:
        return (len(self.sample_shifts) - 1) // 2

    @property
    def spacing_chips(self) -> float:
        """Realized early-late spacing in chips (for DLL gain normalization)."""
        return (
            (self.sample_shifts[-1] - self.sample_shifts[0])
            * self.code_frequency
            / self.sampling_frequency
        )


class TrackState(NamedTuple):
    """Per-channel dynamic state (leading axes may be batched over channels)."""

    prn: jnp.ndarray              # int32, 0-based
    carrier_doppler: jnp.ndarray  # Hz
    carrier_phase: jnp.ndarray    # rad, in [0, 2 pi)
    code_doppler: jnp.ndarray     # chips/s offset from nominal
    code_phase: jnp.ndarray       # chips, in [0, code_length)
    pll_filter: LoopFilterState
    dll_filter: LoopFilterState
    cn0: cn0_mod.CN0State
    ms_elapsed: jnp.ndarray       # int32
    prev_prompt_re: jnp.ndarray   # previous block's prompt (FLL discriminator)
    prev_prompt_im: jnp.ndarray
    # Running coherent accumulators over the current integration window
    # ([..., L] beamformed taps; zeros when config.coherent_blocks == 1).
    coh_re: jnp.ndarray
    coh_im: jnp.ndarray


class TrackOutput(NamedTuple):
    """Per-block observables (what the reference reads back as accumulators)."""

    accum_re: jnp.ndarray         # [..., L] (or [..., A, L] multi-antenna)
    accum_im: jnp.ndarray
    prompt_re: jnp.ndarray
    prompt_im: jnp.ndarray
    carrier_doppler: jnp.ndarray
    code_doppler: jnp.ndarray
    carrier_phase: jnp.ndarray
    code_phase: jnp.ndarray
    pll_error: jnp.ndarray        # cycles
    dll_error: jnp.ndarray        # chips
    cn0_dbhz: jnp.ndarray


def init_state(
    prn: int | np.ndarray,
    carrier_doppler: float | np.ndarray = 0.0,
    carrier_phase: float | np.ndarray = 0.0,
    code_phase: float | np.ndarray = 0.0,
    cn0_window: int = 20,
    ms_elapsed: int | np.ndarray = 0,
    num_taps: int = 3,
) -> TrackState:
    """Build an initial state; array arguments create a batched channel bank.

    ``ms_elapsed`` seeds the block counter — set it to the detected overlay
    offset (`tracking.secondary.detect_secondary_offset`) so
    `TrackConfig.secondary_code` wipe-off starts phase-aligned.
    """
    prn = jnp.asarray(prn, jnp.int32)
    batch = prn.shape

    def full(v):
        return jnp.broadcast_to(jnp.asarray(v, jnp.float32), batch)

    def lf(v=0.0):
        return LoopFilterState(full(v), full(0.0))

    return TrackState(
        prn=prn,
        carrier_doppler=full(carrier_doppler),
        carrier_phase=full(carrier_phase),
        code_doppler=full(0.0),
        code_phase=full(code_phase),
        # Seed the PLL velocity integrator with the acquisition Doppler:
        # the loop filter's output is an absolute rate command, so an
        # unseeded integrator would yank the NCO back toward 0 Hz on the
        # first block and lose lock.
        pll_filter=lf(carrier_doppler),
        dll_filter=lf(),
        cn0=cn0_mod.CN0State(
            jnp.zeros(batch + (cn0_window,), jnp.float32),
            jnp.zeros(batch + (cn0_window,), jnp.float32),
            jnp.zeros(batch, jnp.int32),
        ),
        ms_elapsed=jnp.broadcast_to(
            jnp.asarray(ms_elapsed, jnp.int32), batch
        ),
        prev_prompt_re=full(0.0),
        prev_prompt_im=full(0.0),
        coh_re=jnp.zeros(batch + (num_taps,), jnp.float32),
        coh_im=jnp.zeros(batch + (num_taps,), jnp.float32),
    )

"""GPS L5 pilot/data dual-component tracking.

L5 broadcasts two quadrature components from each satellite: I5 (data: ranging
code x NH10 overlay x 100 sps nav symbols) and Q5 (pilot: a different ranging
code x NH20, dataless). A dual-component channel correlates BOTH codes against
the shared front end and closes the loop on the PILOT — full-range atan2 PLL
(no data modulation after NH20 wipe-off, ~6 dB threshold gain over Costas) and
unlimited coherent integration — while the data component is demodulated with
the pilot-driven NCOs. This is the capability the reference's GPSL5 benchmarks
feed into (role of Tracking.jl's multi-component `TrackingState`; L5 system
usage `/root/reference/src/benchmarks.jl:43-61`, `scripts/run_benchmarks_gpsl5.jl`).

The K dual channels run as ONE 2K-channel bank through the bank correlator —
data codes in columns [0, P), pilot codes in [P, 2P) of a combined code
table — so the whole dual bank is still one correlation per block, and the
loop closure stays [K]-vector math.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..models import gpsl5
from ..ops import registry
from .state import TrackConfig, TrackOutput, TrackState
from .track import loop_update


class DualTrackOutput(NamedTuple):
    """Per-block observables of a dual-component channel bank."""

    pilot: TrackOutput            # pilot-driven loop observables
    data_prompt_re: jnp.ndarray   # [K] overlay-wiped data prompt (nav symbols)
    data_prompt_im: jnp.ndarray


def dual_config(config: TrackConfig) -> TrackConfig:
    """Adapt a TrackConfig for pilot-driven loop closure."""
    import dataclasses

    return dataclasses.replace(
        config, pll_discriminator="atan2", secondary_code=()
    )


import functools


@functools.partial(jax.jit, static_argnames=("config",))
def track_bank_dual(
    config: TrackConfig,
    codes_data: jax.Array,
    codes_pilot: jax.Array,
    states: TrackState,
    signal_re: jax.Array,
    signal_im: jax.Array,
    data_secondary=None,
    pilot_secondary=None,
) -> tuple[TrackState, DualTrackOutput]:
    """Track a K-channel dual-component (data+pilot) bank over ``[B, ..., N]``.

    ``codes_data`` / ``codes_pilot``: ``[Lc, P]`` +/-1 chip tables (I5 / Q5).
    ``states.prn`` indexes into both tables; overlay wipe-off uses the
    channel's ``ms_elapsed`` (align via secondary sync). The loop closes on
    the pilot; data prompts are returned overlay-wiped, so their signs are
    the 100 sps nav symbols (10 repeats each at 1 ms blocks).
    """
    if config.secondary_code:
        raise ValueError(
            "use dual_config(): overlay wipe-off is per-component here"
        )
    num_k = states.prn.shape[0]
    num_p = codes_data.shape[1]
    codes = jnp.concatenate(
        [jnp.asarray(codes_data), jnp.asarray(codes_pilot)], axis=1
    )
    sd = jnp.asarray(
        gpsl5.neuman_hofman(False) if data_secondary is None
        else data_secondary, jnp.float32,
    )
    sp = jnp.asarray(
        gpsl5.neuman_hofman(True) if pilot_secondary is None
        else pilot_secondary, jnp.float32,
    )
    prn2 = jnp.concatenate([states.prn, states.prn + num_p])
    corr = registry.get(config.algorithm)
    is_bank = config.algorithm in registry.BANK_ALGORITHMS

    def correlate(st, sre, sim):
        f_car = config.intermediate_frequency + st.carrier_doppler   # [K]
        f_code = config.code_frequency + st.code_doppler

        def dup(x):
            return jnp.concatenate([x, x], axis=0)

        if is_bank:
            return corr(
                sre, sim, codes, prn2, dup(f_car),
                carrier_phase=dup(st.carrier_phase),
                code_frequency=dup(f_code), code_phase=dup(st.code_phase),
                sample_shifts=config.sample_shifts,
                code_length=config.code_length,
                sampling_frequency=config.sampling_frequency,
            )

        def one(prn, fc, ph, fcode, cp):
            return corr(
                sre, sim, codes, prn, fc, config.sampling_frequency, ph,
                fcode, cp, config.sample_shifts, config.code_length,
            )

        return jax.vmap(one)(
            prn2, dup(f_car), dup(st.carrier_phase), dup(f_code),
            dup(st.code_phase),
        )

    def body(st, sig):
        sre, sim = sig
        are, aim = correlate(st, sre, sim)
        d_re, p_re = are[:num_k], are[num_k:]
        d_im, p_im = aim[:num_k], aim[num_k:]

        def wipe(x, sc):
            sgn = sc[st.ms_elapsed % sc.shape[0]]
            return x * sgn.reshape(sgn.shape + (1,) * (x.ndim - sgn.ndim))

        d_re, d_im = wipe(d_re, sd), wipe(d_im, sd)
        p_re, p_im = wipe(p_re, sp), wipe(p_im, sp)
        # The pilot is transmitted in phase quadrature (+90 deg) to the data:
        # rotate its accumulators by -90 deg so zero loop phase error puts
        # the data component on I (nav symbols = sign of data_prompt_re).
        p_re, p_im = p_im, -p_re

        st2, out = jax.vmap(
            lambda s, a, b: loop_update(config, s, a, b)
        )(st, p_re, p_im)
        pidx = config.prompt_index
        return st2, DualTrackOutput(
            pilot=out,
            data_prompt_re=d_re[..., pidx].sum(axis=tuple(range(1, d_re.ndim - 1))),
            data_prompt_im=d_im[..., pidx].sum(axis=tuple(range(1, d_im.ndim - 1))),
        )

    return lax.scan(body, states, (signal_re, signal_im))

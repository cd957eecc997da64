"""Closed-loop tracking: per-block correlate -> discriminate -> filter -> NCO.

The on-device equivalent of Tracking.jl's `track` loop (which the reference's
CPU baseline benchmarks via `Tracking.downconvert_and_correlate!`,
`/root/reference/src/benchmarks.jl:35-80`), designed per SURVEY.md §7 step 4:
the whole loop body is one jitted function, multi-millisecond runs are a
`lax.scan` whose carries are the NCO phases and filter states — zero host
round-trips — and channel banks are `vmap`/`shard_map` batches of the same
function.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops import registry
from . import cn0 as cn0_mod
from . import discriminators, loop_filter
from .state import TrackConfig, TrackOutput, TrackState


def track_step(
    config: TrackConfig,
    codes: jax.Array,
    state: TrackState,
    signal_re: jax.Array,
    signal_im: jax.Array,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Process one integration block for one channel.

    ``signal_*``: ``[N]`` or ``[A, N]``. Multi-antenna blocks are correlated
    per antenna; discriminators run on the beamformed accumulators
    (``ant_weights``: optional ``(w_re, w_im)`` ``[A]`` steering weights,
    applied as ``sum_a conj(w_a) x_a``; None = uniform sum — the Tracking.jl
    ``beamform`` role). Per-antenna accumulators are still reported, matching
    the reference's ``accum[ant, corr]`` output.
    """
    corr = registry.get(config.algorithm)
    carrier_freq = config.intermediate_frequency + state.carrier_doppler
    code_freq = config.code_frequency + state.code_doppler

    accum_re, accum_im = corr(
        signal_re,
        signal_im,
        codes,
        state.prn,
        carrier_freq,
        config.sampling_frequency,
        state.carrier_phase,
        code_freq,
        state.code_phase,
        config.sample_shifts,
        config.code_length,
    )
    return loop_update(config, state, accum_re, accum_im, ant_weights)


def _beamform(accum_re, accum_im, ant_weights):
    """Steered antenna combination ``sum_a conj(w_a) x_a`` over axis -2."""
    if accum_re.ndim == 1:
        return accum_re, accum_im
    if ant_weights is None:
        return accum_re.sum(axis=-2), accum_im.sum(axis=-2)
    w_re, w_im = ant_weights
    w_re = jnp.asarray(w_re, jnp.float32)[..., :, None]
    w_im = jnp.asarray(w_im, jnp.float32)[..., :, None]
    bf_re = (w_re * accum_re + w_im * accum_im).sum(axis=-2)
    bf_im = (w_re * accum_im - w_im * accum_re).sum(axis=-2)
    return bf_re, bf_im


def loop_update(
    config: TrackConfig,
    state: TrackState,
    accum_re: jax.Array,
    accum_im: jax.Array,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Close the loop on one block's accumulators: discriminate -> filter -> NCO.

    Split out of `track_step` so distributed paths (`parallel.bank`) can feed
    mesh-sharded correlation results into the identical loop closure.
    """
    t = config.integration_time
    carrier_freq = config.intermediate_frequency + state.carrier_doppler
    code_freq = config.code_frequency + state.code_doppler

    # Secondary-code (overlay) wipe-off: remove the per-block +/-1 sign (e.g.
    # L5 Neuman-Hofman) before the discriminators, so the FLL sees phase
    # continuity and coherent post-integration is sign-clean. The index is
    # the channel's block counter; align via init_state(ms_elapsed=...) after
    # secondary sync (`tracking.secondary.detect_secondary_offset`).
    if config.secondary_code:
        sc = jnp.asarray(config.secondary_code, jnp.float32)
        sign = sc[state.ms_elapsed % len(config.secondary_code)]
        sign = sign.reshape(sign.shape + (1,) * (accum_re.ndim - sign.ndim))
        accum_re = accum_re * sign
        accum_im = accum_im * sign

    # Beamform over any antenna axis for the discriminators.
    bf_re, bf_im = _beamform(accum_re, accum_im, ant_weights)
    pidx = config.prompt_index

    # Coherent post-integration: accumulate overlay-wiped taps over a
    # k_coh-block window; the discriminators/filters see the windowed sums
    # and only update at window boundaries (masked select below). NCO phases
    # still advance every block.
    k_coh = max(int(config.coherent_blocks), 1)
    if k_coh > 1:
        coh_re = state.coh_re + bf_re
        coh_im = state.coh_im + bf_im
        boundary = (state.ms_elapsed + 1) % k_coh == 0
        t_coh = jnp.float32(t * k_coh)
    else:
        coh_re, coh_im = bf_re, bf_im
        boundary = None
        t_coh = jnp.float32(t)
    prompt_re, prompt_im = coh_re[..., pidx], coh_im[..., pidx]

    pll_disc = (
        discriminators.pll_atan2
        if config.pll_discriminator == "atan2"
        else discriminators.pll_costas
    )
    pll_err = pll_disc(prompt_re, prompt_im)
    # Early = most-advanced replica (largest positive sample shift, last tap).
    dll_err = discriminators.dll_emle(
        coh_re[..., -1], coh_im[..., -1], coh_re[..., 0], coh_im[..., 0],
        config.spacing_chips,
    )
    # FLL assist from consecutive (windowed) prompts, zeroed until a previous
    # window's prompt exists to difference against. Costas configs (data-
    # bearing component) pair with the data-insensitive atan FLL; atan2
    # configs (dataless pilot) use the full-range variant.
    fll_disc = (
        discriminators.fll_atan2
        if config.pll_discriminator == "atan2"
        else discriminators.fll_atan
    )
    fll_err = fll_disc(
        state.prev_prompt_re, state.prev_prompt_im, prompt_re, prompt_im,
        t_coh,
    )
    fll_err = jnp.where(state.ms_elapsed >= k_coh, fll_err, 0.0)

    pll_state, doppler_cmd = loop_filter.step(
        state.pll_filter, pll_err, t_coh, config.pll_bandwidth,
        config.pll_order,
        fll_error=fll_err, fll_bandwidth=config.fll_bandwidth,
    )
    dll_state, code_cmd = loop_filter.step(
        state.dll_filter, dll_err, t_coh, config.dll_bandwidth,
        config.dll_order
    )

    # Carrier aiding: code Doppler follows carrier Doppler scaled into chip rate
    # (code_frequency / center_frequency), plus the DLL's own correction.
    new_carrier_doppler = doppler_cmd
    new_code_doppler = (
        code_cmd + new_carrier_doppler * config.code_frequency / config.center_frequency
    )

    if k_coh > 1:
        # Between boundaries: keep the old filter states / Doppler commands,
        # keep accumulating; at a boundary: adopt the update, reset the window.
        def sel(new, old):
            return jax.tree.map(
                lambda a, b: jnp.where(
                    boundary.reshape(boundary.shape + (1,) * (a.ndim - boundary.ndim)),
                    a, b,
                ),
                new, old,
            )

        pll_state = sel(pll_state, state.pll_filter)
        dll_state = sel(dll_state, state.dll_filter)
        new_carrier_doppler = sel(new_carrier_doppler, state.carrier_doppler)
        new_code_doppler = sel(new_code_doppler, state.code_doppler)
        prompt_keep = sel(prompt_re, state.prev_prompt_re)
        prompt_keep_im = sel(prompt_im, state.prev_prompt_im)
        coh_re = sel(jnp.zeros_like(coh_re), coh_re)
        coh_im = sel(jnp.zeros_like(coh_im), coh_im)
        pll_err = sel(pll_err, jnp.zeros_like(pll_err))
        dll_err = sel(dll_err, jnp.zeros_like(dll_err))
    else:
        prompt_keep, prompt_keep_im = prompt_re, prompt_im
        coh_re = jnp.zeros_like(state.coh_re)
        coh_im = jnp.zeros_like(state.coh_im)

    # NCO phase propagation over the block just consumed (with the frequencies
    # that generated its replicas), wrapped to keep f32 exact.
    two_pi = jnp.float32(2 * jnp.pi)
    carrier_phase = jnp.mod(
        state.carrier_phase + two_pi * carrier_freq * jnp.float32(t), two_pi
    )
    code_phase = jnp.mod(
        state.code_phase + code_freq * jnp.float32(t), jnp.float32(config.code_length)
    )

    # C/N0 runs on the per-block prompt regardless of the coherent window.
    cn0_state = cn0_mod.update(
        state.cn0, bf_re[..., pidx], bf_im[..., pidx]
    )
    cn0_dbhz = cn0_mod.estimate(cn0_state, jnp.float32(t))

    new_state = TrackState(
        prn=state.prn,
        carrier_doppler=new_carrier_doppler,
        carrier_phase=carrier_phase,
        code_doppler=new_code_doppler,
        code_phase=code_phase,
        pll_filter=pll_state,
        dll_filter=dll_state,
        cn0=cn0_state,
        ms_elapsed=state.ms_elapsed + 1,
        prev_prompt_re=prompt_keep,
        prev_prompt_im=prompt_keep_im,
        coh_re=coh_re,
        coh_im=coh_im,
    )
    output = TrackOutput(
        accum_re=accum_re,
        accum_im=accum_im,
        prompt_re=prompt_re,
        prompt_im=prompt_im,
        carrier_doppler=new_carrier_doppler,
        code_doppler=new_code_doppler,
        carrier_phase=carrier_phase,
        code_phase=code_phase,
        pll_error=pll_err,
        dll_error=dll_err,
        cn0_dbhz=cn0_dbhz,
    )
    return new_state, output


@functools.partial(jax.jit, static_argnames=("config",))
def track(
    config: TrackConfig,
    codes: jax.Array,
    state: TrackState,
    signal_re: jax.Array,
    signal_im: jax.Array,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Track a multi-block signal ``[num_blocks, ..., N]`` via `lax.scan`.

    Returns the final state and per-block stacked outputs. The scan carries the
    full loop state on device in place of the reference's host-driven
    per-ms kernel relaunch. ``ant_weights``: optional
    ``(w_re, w_im)`` ``[A]`` beamforming weights (see `track_step`).
    """

    def body(st, sig):
        sre, sim = sig
        return track_step(config, codes, st, sre, sim, ant_weights)

    return jax.lax.scan(body, state, (signal_re, signal_im))


@functools.partial(jax.jit, static_argnames=("config",))
def track_bank(
    config: TrackConfig,
    codes: jax.Array,
    states: TrackState,
    signal_re: jax.Array,
    signal_im: jax.Array,
    ant_weights: Optional[tuple] = None,
) -> tuple[TrackState, TrackOutput]:
    """Track a K-channel bank over ``[num_blocks, ..., N]`` blocks.

    ``states`` carries a leading channel axis ``[K]``; the signal is shared
    across channels (one RF front-end feeding the bank, shapes ``[B, N]`` or
    ``[B, A, N]``) — each channel wipes off its own Doppler/code phase, the
    multi-satellite capability of the reference's 3-D kernels
    (`/root/reference/src/algorithms.jl:637-718`) extended with closed loops.

    When ``config.algorithm`` is a bank correlator (``xla_bank``,
    ``triton_bank``), the whole bank correlates in one call per block;
    otherwise each channel runs the per-channel algorithm under `vmap`.
    ``ant_weights``: optional ``(w_re, w_im)`` of shape ``[A]`` (shared) or
    ``[K, A]`` (per channel)
    beamforming weights.
    """
    num_k = states.prn.shape[0]
    if ant_weights is not None:
        num_ants = signal_re.shape[-2] if signal_re.ndim == 3 else 1
        w_re = jnp.broadcast_to(
            jnp.asarray(ant_weights[0], jnp.float32), (num_k, num_ants)
        )
        w_im = jnp.broadcast_to(
            jnp.asarray(ant_weights[1], jnp.float32), (num_k, num_ants)
        )
        ant_weights = (w_re, w_im)

    def vmap_update(st, are, aim):
        if ant_weights is None:
            return jax.vmap(
                lambda s, a, b: loop_update(config, s, a, b)
            )(st, are, aim)
        return jax.vmap(
            lambda s, a, b, wr, wi: loop_update(config, s, a, b, (wr, wi))
        )(st, are, aim, *ant_weights)

    if config.algorithm in registry.BANK_ALGORITHMS:
        corr = registry.get(config.algorithm)

        def body(st, sig):
            sre, sim = sig
            f_car = config.intermediate_frequency + st.carrier_doppler   # [K]
            f_code = config.code_frequency + st.code_doppler
            accum_re, accum_im = corr(
                sre, sim, codes, st.prn, f_car,
                carrier_phase=st.carrier_phase,
                code_frequency=f_code,
                code_phase=st.code_phase,
                sample_shifts=config.sample_shifts,
                code_length=config.code_length,
                sampling_frequency=config.sampling_frequency,
            )
            return vmap_update(st, accum_re, accum_im)

        return jax.lax.scan(body, states, (signal_re, signal_im))

    def body(st, sig):
        sre, sim = sig
        corr = registry.get(config.algorithm)

        def one(s):
            f_car = config.intermediate_frequency + s.carrier_doppler
            f_code = config.code_frequency + s.code_doppler
            return corr(
                sre, sim, codes, s.prn, f_car, config.sampling_frequency,
                s.carrier_phase, f_code, s.code_phase, config.sample_shifts,
                config.code_length,
            )

        accum_re, accum_im = jax.vmap(one)(st)
        return vmap_update(st, accum_re, accum_im)

    return jax.lax.scan(body, states, (signal_re, signal_im))

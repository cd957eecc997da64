"""Mesh-sharded multi-channel tracking: the distributed flagship step.

The reference defers multi-channel scale-out entirely (`paper/paper.tex:114`,
"future work"; its closest artifact is the 3-D multi-satellite kernel,
`/root/reference/src/algorithms.jl:637-718`, still one GPU). Here the channel
bank is the unit of scale: a ``(chan, time)`` mesh where

- the **chan** axis shards satellite channels (data-parallel: states live
  sharded, zero communication),
- the **time** axis shards each integration block's sample axis
  (sequence-parallel: replicas are regenerated per shard from phase-advanced
  NCOs — see `parallel.correlate` — and partial accumulators meet in one
  ``psum`` of ``[L]`` scalars per channel per block).

The whole multi-block run is a single jitted `lax.scan` whose carry (the bank
state pytree) never leaves the devices, and the loop closure after the psum is
computed redundantly-but-identically on every time shard, so no broadcast is
needed either.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import registry
from ..tracking.state import TrackConfig, TrackOutput, TrackState
from ..tracking.track import loop_update
from .correlate import advance_phases, nominal_advance_tables
from .mesh import CHAN_AXIS, TIME_AXIS


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "chan_axis", "time_axis")
)
def track_bank_sharded(
    config: TrackConfig,
    codes: jax.Array,
    states: TrackState,
    signal_re: jax.Array,
    signal_im: jax.Array,
    *,
    mesh: Mesh,
    chan_axis: str = CHAN_AXIS,
    time_axis: str = TIME_AXIS,
) -> tuple[TrackState, TrackOutput]:
    """Track a K-channel bank over ``[B, N]`` / ``[B, A, N]`` blocks on a mesh.

    ``states`` leaves carry a leading ``[K]`` axis, sharded over ``chan_axis``;
    the shared front-end signal is sharded over ``time_axis`` on its sample
    axis and replicated over channels. Returns (final states, per-block
    outputs ``[B, K, ...]``) with the same shardings.
    """
    num_chan = mesh.shape[chan_axis]
    num_time = mesh.shape[time_axis]
    num_k = states.prn.shape[0]
    num_samples = signal_re.shape[-1]
    if num_k % num_chan:
        raise ValueError(f"K={num_k} not divisible by {num_chan} channel shards")
    if num_samples % num_time:
        raise ValueError(f"N={num_samples} not divisible by {num_time} time shards")
    if num_samples != config.num_samples:
        raise ValueError("signal block length != config.num_samples")
    local_n = num_samples // num_time

    tables = nominal_advance_tables(
        config.intermediate_frequency, config.code_frequency,
        config.sampling_frequency, local_n, num_time, config.code_length,
    )
    corr = registry.get(config.algorithm)
    advance = functools.partial(
        advance_phases,
        nominal_carrier_frequency=config.intermediate_frequency,
        nominal_code_frequency=config.code_frequency,
        sampling_frequency=config.sampling_frequency,
        samples_per_shard=local_n,
        code_length=config.code_length,
    )

    is_bank_algo = config.algorithm in registry.BANK_ALGORITHMS

    def channel_step(state, sre, sim, ti):
        f_car = config.intermediate_frequency + state.carrier_doppler
        f_code = config.code_frequency + state.code_doppler
        phi_car_l, phi_code_l = advance(
            state.carrier_phase, state.code_phase, f_car, f_code, ti, tables
        )
        are, aim = corr(
            sre, sim, codes, state.prn, f_car, config.sampling_frequency,
            phi_car_l, f_code, phi_code_l, config.sample_shifts,
            config.code_length,
        )
        are = lax.psum(are, time_axis)
        aim = lax.psum(aim, time_axis)
        # Loop closure on the full-block accumulators; identical on every time
        # shard, so the carry stays consistent without a broadcast.
        return loop_update(config, state, are, aim)

    def bank_step(states_, sre, sim, ti):
        # One bank correlation for all local channels.
        f_car = config.intermediate_frequency + states_.carrier_doppler  # [K]
        f_code = config.code_frequency + states_.code_doppler
        phi_car_l, phi_code_l = advance(
            states_.carrier_phase, states_.code_phase, f_car, f_code, ti,
            tables,
        )
        are, aim = corr(
            sre, sim, codes, states_.prn, f_car,
            carrier_phase=phi_car_l, code_frequency=f_code,
            code_phase=phi_code_l, sample_shifts=config.sample_shifts,
            code_length=config.code_length,
            sampling_frequency=config.sampling_frequency,
        )
        are = lax.psum(are, time_axis)
        aim = lax.psum(aim, time_axis)
        return jax.vmap(lambda s, r, m: loop_update(config, s, r, m))(
            states_, are, aim
        )

    def body(local_states, sre, sim):
        ti = lax.axis_index(time_axis)

        def block(st, sig):
            bre, bim = sig
            if is_bank_algo:
                return bank_step(st, bre, bim, ti)
            st2, out = jax.vmap(lambda s: channel_step(s, bre, bim, ti))(st)
            return st2, out

        return lax.scan(block, local_states, (sre, sim))

    state_specs = jax.tree.map(lambda _: P(chan_axis), states)
    sig_spec = P(*((None,) * (signal_re.ndim - 1)), time_axis)
    out_state_specs = jax.tree.map(lambda _: P(chan_axis), states)
    # Outputs are [B, K_local, ...] inside the shard: block axis replicated,
    # channel axis sharded.
    out_specs_tree = TrackOutput(
        *(P(None, chan_axis) for _ in TrackOutput._fields)
    )
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(state_specs, sig_spec, sig_spec),
        out_specs=(out_state_specs, out_specs_tree),
        check_vma=False,
    )
    return sharded(states, signal_re, signal_im)


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "chan_axis")
)
def track_bank_dual_sharded(
    config: TrackConfig,
    codes_data: jax.Array,
    codes_pilot: jax.Array,
    states: TrackState,
    signal_re: jax.Array,
    signal_im: jax.Array,
    *,
    mesh: Mesh,
    chan_axis: str = CHAN_AXIS,
):
    """Mesh-sharded GPS L5 dual-component bank: channel data parallelism.

    The multi-chip leg of the mixed L1+L5 claim (RESULTS.md "north-star
    sentence"): K dual channels (each a data+pilot pair -> 2K bank channels
    per shard-local launch) shard over ``chan_axis`` with ZERO hot-path
    communication — dual channels are independent given the shared front
    end, which is replicated (`tracking.dual.track_bank_dual` runs whole
    inside each shard: one bank kernel launch + NH wipe-off + pilot atan2
    closure per block). Time-axis sharding is not plumbed here: overlay
    wipe-off is per-block logic, and channel sharding alone is the
    deployment geometry the measured chips-for-real-time numbers compose
    under.
    """
    from ..tracking.dual import DualTrackOutput, track_bank_dual

    num_chan = mesh.shape[chan_axis]
    num_k = states.prn.shape[0]
    if num_k % num_chan:
        raise ValueError(f"K={num_k} not divisible by {num_chan} chan shards")

    def body(local_states, sre, sim):
        return track_bank_dual(
            config, codes_data, codes_pilot, local_states, sre, sim
        )

    state_specs = jax.tree.map(lambda _: P(chan_axis), states)
    sig_spec = P(*((None,) * signal_re.ndim))
    out_specs = (
        jax.tree.map(lambda _: P(chan_axis), states),
        DualTrackOutput(
            pilot=TrackOutput(
                *(P(None, chan_axis) for _ in TrackOutput._fields)
            ),
            data_prompt_re=P(None, chan_axis),
            data_prompt_im=P(None, chan_axis),
        ),
    )
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(state_specs, sig_spec, sig_spec),
        out_specs=out_specs,
        check_vma=False,
    )
    return sharded(states, signal_re, signal_im)

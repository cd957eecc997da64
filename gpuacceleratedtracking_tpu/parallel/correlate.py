"""Mesh-sharded EPL correlation (sequence-parallel time axis + antenna psum).

The reference scales the sample axis only *within* one GPU (grid-stride loops +
multi-pass Harris reduction, `/root/reference/src/algorithms.jl:34-54`,
`/root/reference/src/reduction.jl:93-159`) and keeps a ``num_samples +
num_of_shifts`` replica halo so every tap is a shifted view
(`/root/reference/src/benchmarks.jl:847-848`). Sharding that design across
chips would need an overlap-save halo exchange of signal/replica samples.

This design needs **no halo exchange at all**: code and carrier
replicas are pure phase arithmetic from (frequency, start-phase, sample index),
so each time shard regenerates its own replica — including the tap lookahead
past its block edge — from a phase-advanced NCO, and the only collective is a
`lax.psum` of the tiny ``[A, L]`` accumulators. Sample index never crosses a
chip; phases do, exactly.

f32 phase-advance accuracy over big blocks (N up to 2**18) is preserved by
splitting the advance into a *nominal* part — computed per shard index in f64
at trace time and folded mod code-length/cycle into a static table — and a
small *Doppler residual* part computed in f32 on device.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import registry
from .mesh import ANT_AXIS, TIME_AXIS

_TWO_PI = 2.0 * np.pi


def nominal_advance_tables(
    nominal_carrier_frequency: float,
    nominal_code_frequency: float,
    sampling_frequency: float,
    samples_per_shard: int,
    num_shards: int,
    code_length: int,
) -> tuple[jax.Array, jax.Array]:
    """Static per-shard phase advances, exact in f64, reduced, then cast f32.

    Entry ``t``: carrier advance in cycles mod 1 and code advance in chips mod
    code_length accumulated over ``t * samples_per_shard`` samples at the
    nominal frequencies.
    """
    t = np.arange(num_shards, dtype=np.float64)
    n0 = t * float(samples_per_shard)
    car = np.mod(float(nominal_carrier_frequency) / float(sampling_frequency) * n0, 1.0)
    code = np.mod(
        float(nominal_code_frequency) / float(sampling_frequency) * n0,
        float(code_length),
    )
    return jnp.asarray(car, jnp.float32), jnp.asarray(code, jnp.float32)


def advance_phases(
    carrier_phase,
    code_phase,
    carrier_frequency,
    code_frequency,
    shard_index,
    tables: tuple[jax.Array, jax.Array],
    nominal_carrier_frequency: float,
    nominal_code_frequency: float,
    sampling_frequency: float,
    samples_per_shard: int,
    code_length: int,
):
    """Phase-advance (carrier rad, code chips) to this shard's first sample.

    The nominal advance comes from the precomputed table; only the (small)
    Doppler residual ``(f - f_nom)/fs * n0`` is evaluated in f32.
    """
    car_tab, code_tab = tables
    n0 = (shard_index * samples_per_shard).astype(jnp.float32)
    inv_fs = jnp.float32(1.0 / sampling_frequency)

    dcar_cyc = (carrier_frequency - jnp.float32(nominal_carrier_frequency)) * inv_fs * n0
    cyc = jnp.take(car_tab, shard_index) + dcar_cyc
    cyc = cyc - jnp.floor(cyc)
    carrier_local = jnp.mod(
        carrier_phase + jnp.float32(_TWO_PI) * cyc, jnp.float32(_TWO_PI)
    )

    dcode = (code_frequency - jnp.float32(nominal_code_frequency)) * inv_fs * n0
    code_local = jnp.mod(
        code_phase + jnp.take(code_tab, shard_index) + dcode,
        jnp.float32(code_length),
    )
    return carrier_local, code_local


def correlate_sharded(
    signal_re: jax.Array,
    signal_im: jax.Array,
    codes: jax.Array,
    prn,
    carrier_frequency,
    sampling_frequency: float,
    carrier_phase,
    code_frequency,
    code_phase,
    sample_shifts: Sequence[int],
    code_length: int,
    *,
    mesh: Mesh,
    nominal_carrier_frequency: float = 0.0,
    nominal_code_frequency: Optional[float] = None,
    algorithm: str = "fused_xla",
    time_axis: str = TIME_AXIS,
    ant_axis: Optional[str] = None,
    beamform: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Correlate one block with its sample axis sharded over ``time_axis``.

    Same positional signature as the `ops.registry` algorithms, plus the mesh
    layout. ``signal_*`` is ``[N]`` or ``[A, N]``; ``N`` is split over
    ``time_axis`` and (optionally) ``A`` over ``ant_axis``. ``sampling_frequency``
    and the two nominal frequencies must be static Python floats (they seed the
    f64 advance tables). Returns accumulators replicated over ``time_axis``;
    with ``beamform=True`` the antenna axis is psum-reduced (TP-style
    beamforming) and the result is ``[L]``.
    """
    if nominal_code_frequency is None:
        raise ValueError("nominal_code_frequency (static) is required")
    num_samples = signal_re.shape[-1]
    num_time = mesh.shape[time_axis]
    if num_samples % num_time:
        raise ValueError(f"N={num_samples} not divisible by {num_time} time shards")
    local_n = num_samples // num_time
    tables = nominal_advance_tables(
        nominal_carrier_frequency, nominal_code_frequency, sampling_frequency,
        local_n, num_time, code_length,
    )
    corr = registry.get(algorithm)
    has_ant = signal_re.ndim == 2
    ant_sharded = has_ant and ant_axis is not None

    sig_spec = (
        P(ant_axis if ant_sharded else None, time_axis) if has_ant else P(time_axis)
    )
    if beamform and has_ant:
        out_spec = P()
    elif has_ant:
        out_spec = P(ant_axis if ant_sharded else None, None)
    else:
        out_spec = P()

    advance = functools.partial(
        advance_phases,
        nominal_carrier_frequency=nominal_carrier_frequency,
        nominal_code_frequency=nominal_code_frequency,
        sampling_frequency=sampling_frequency,
        samples_per_shard=local_n,
        code_length=code_length,
    )

    def body(sre, sim, codes_, prn_, f_car, phi_car, f_code, phi_code, car_tab, code_tab):
        ti = lax.axis_index(time_axis)
        phi_car_l, phi_code_l = advance(
            phi_car, phi_code, f_car, f_code, ti, (car_tab, code_tab)
        )
        are, aim = corr(
            sre, sim, codes_, prn_, f_car, sampling_frequency, phi_car_l,
            f_code, phi_code_l, sample_shifts, code_length,
        )
        are = lax.psum(are, time_axis)
        aim = lax.psum(aim, time_axis)
        if beamform and has_ant:
            are, aim = are.sum(axis=-2), aim.sum(axis=-2)
            if ant_sharded:
                are = lax.psum(are, ant_axis)
                aim = lax.psum(aim, ant_axis)
        return are, aim

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(sig_spec, sig_spec, P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(out_spec, out_spec),
        check_vma=False,
    )
    return sharded(
        signal_re, signal_im, codes, jnp.asarray(prn),
        jnp.asarray(carrier_frequency, jnp.float32),
        jnp.asarray(carrier_phase, jnp.float32),
        jnp.asarray(code_frequency, jnp.float32),
        jnp.asarray(code_phase, jnp.float32),
        *tables,
    )

"""Bank correlator as one Pallas kernel on the Triton route (Hopper candidate).

The same computation as `correlate.correlate_xla_bank`, laid out after the
reference's 3-D multi-satellite kernel (`/root/reference/src/algorithms.jl:
637-718`): the grid is (channel, sample tile); each program loads its own
channel's NCO parameters, reads one ``[A, rows, 128]`` signal tile (shared by
every channel through L2), builds the carrier from ``rows + 128`` sin/cos
pairs (row phasor times lane phasor) instead of one per sample, gathers each
tap's chips from the flat code table by pointer (the texture fetch's role),
and reduces the ``A x L x (re, im)`` products of the tile to scalars. Tile
partials land in ``[K, T, A, L]`` and XLA sums them over ``T``: no atomics,
so the result is the same from run to run.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .correlate import chip_from_terms, code_nco_terms

_LANES = 128
_TILE_ROWS = 16         # 2048 samples per program
_NUM_WARPS = 4          # 32 rows x 8 warps measured slower in every cell
_TWO_PI = 2.0 * 3.141592653589793


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _bank_kernel(params_ref, table_ref, sre_ref, sim_ref, ore_ref, oim_ref, *,
                 shifts, rows, num_ants, code_length, num_prns):
    t = pl.program_id(1)
    f_cyc, phi_cyc = params_ref[0], params_ref[1]
    terms = (params_ref[2], params_ref[3], params_ref[4],
             params_ref[5].astype(jnp.int32), params_ref[6])
    prn = params_ref[7].astype(jnp.int32)

    r = jnp.arange(rows, dtype=jnp.int32)[:, None]
    c = jnp.arange(_LANES, dtype=jnp.int32)[None, :]
    row0 = t * (rows * _LANES) + r * _LANES          # [R, 1], multiple of 128

    # Carrier exp(i 2 pi (f n + phi)) as row phasor x lane phasor.
    cyc_r = f_cyc * row0.astype(jnp.float32)
    cyc_r = cyc_r - jnp.floor(cyc_r) + phi_cyc
    th_r = _TWO_PI * (cyc_r - jnp.floor(cyc_r))
    th_c = _TWO_PI * (f_cyc * c.astype(jnp.float32))
    cr, sr = jnp.cos(th_r), jnp.sin(th_r)
    cc, sc = jnp.cos(th_c), jnp.sin(th_c)
    cos = cr * cc - sr * sc
    sin = sr * cc + cr * sc

    dws = []
    for a in range(num_ants):
        s_re, s_im = sre_ref[a], sim_ref[a]
        dws.append((s_re * cos + s_im * sin, s_im * cos - s_re * sin))

    for l, d in enumerate(shifts):
        chip = chip_from_terms(terms, row0 + c + d, code_length)
        rep = table_ref[chip * num_prns + prn]
        for a, (dw_re, dw_im) in enumerate(dws):
            ore_ref[a, l] = jnp.sum(dw_re * rep)
            oim_ref[a, l] = jnp.sum(dw_im * rep)


@functools.partial(
    jax.jit,
    static_argnames=("sampling_frequency", "sample_shifts", "code_length",
                     "interpret"),
)
def correlate_triton_bank(
    signal_re: jax.Array,
    signal_im: jax.Array,
    codes: jax.Array,
    prn: jax.Array,
    carrier_frequency: jax.Array,
    sampling_frequency: float,
    carrier_phase: jax.Array,
    code_frequency: jax.Array,
    code_phase: jax.Array,
    sample_shifts: Sequence[int],
    code_length: int,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Bank-signature correlator: ``[K]`` channels, shared ``[N]``/``[A, N]``.

    Returns ``[K, L]`` / ``[K, A, L]`` like `correlate.correlate_xla_bank`;
    scalar channel parameters give ``[L]`` / ``[A, L]``. ``interpret`` runs
    the kernel through the Pallas interpreter (tests on the CPU).
    """
    scalar = jnp.ndim(prn) == 0
    prn, carrier_frequency, carrier_phase, code_frequency, code_phase = (
        jnp.atleast_1d(jnp.asarray(x)) for x in (
            prn, carrier_frequency, carrier_phase, code_frequency, code_phase))
    single = signal_re.ndim == 1
    if single:
        signal_re, signal_im = signal_re[None], signal_im[None]
    num_ants, num_samples = signal_re.shape
    num_k = prn.shape[0]
    shifts = tuple(int(d) for d in sample_shifts)
    num_taps = len(shifts)
    tile = _TILE_ROWS * _LANES
    num_tiles = -(-num_samples // tile)
    ants_p, taps_p = _next_pow2(num_ants), _next_pow2(num_taps)

    def tiles(x):
        x = jnp.pad(x.astype(jnp.float32),
                    ((0, ants_p - num_ants), (0, num_tiles * tile - num_samples)))
        return x.reshape(ants_p, num_tiles * _TILE_ROWS, _LANES)

    f32 = jnp.float32
    params = jnp.stack([
        (carrier_frequency / sampling_frequency).astype(f32),
        carrier_phase.astype(f32) / f32(_TWO_PI),
        *(x.astype(f32) for x in code_nco_terms(
            code_frequency, sampling_frequency, code_phase)),
        prn.astype(f32),
    ], axis=1)                                          # [K, 8]
    table = jnp.asarray(codes, f32).reshape(-1)
    table = jnp.pad(table, (0, _next_pow2(table.size) - table.size))

    kernel = functools.partial(
        _bank_kernel, shifts=shifts, rows=_TILE_ROWS, num_ants=num_ants,
        code_length=code_length, num_prns=codes.shape[-1],
    )
    part = jax.ShapeDtypeStruct((num_k, num_tiles, ants_p, taps_p), f32)
    sig_spec = pl.BlockSpec((ants_p, _TILE_ROWS, _LANES),
                            lambda k, t: (0, t, 0))
    out_spec = pl.BlockSpec((None, None, ants_p, taps_p),
                            lambda k, t: (k, t, 0, 0))
    pre, pim = pl.pallas_call(
        kernel,
        out_shape=(part, part),
        grid=(num_k, num_tiles),
        in_specs=[
            pl.BlockSpec((None, 8), lambda k, t: (k, 0)),
            pl.BlockSpec((table.size,), lambda k, t: (0,)),
            sig_spec, sig_spec,
        ],
        out_specs=(out_spec, out_spec),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="triton_bank",
    )(params, table, tiles(signal_re), tiles(signal_im))
    are = pre.sum(axis=1)[:, :num_ants, :num_taps]
    aim = pim.sum(axis=1)[:, :num_ants, :num_taps]
    if single:
        are, aim = are[:, 0], aim[:, 0]
    return (are[0], aim[0]) if scalar else (are, aim)

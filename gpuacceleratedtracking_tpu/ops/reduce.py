"""Accumulator reductions — the Harris-ladder capability, XLA-native.

The reference implements 11 hand-written shared-memory tree reductions
(Harris #3/#4/#5 × scalar/complex/complex-multi, `/root/reference/src/
reduction.jl:1-682`) because CUDA makes cross-block summation manual. In XLA
the ladder collapses: `jnp.sum` over the sample axis compiles to fused
reductions with f32 accumulation. What remains worth keeping is the reference's
*fusion-degree axis* — pure vs cplx vs cplx_multi
(`/root/reference/src/GPUAcceleratedTracking.jl:63-66`) — because it is the
benchmarkable design dimension ("how much do fused reductions win", paper
Fig. ranking cplx_multi > cplx > pure, `/root/reference/paper/paper.tex:299`).

Inputs follow the reference's accumulator layout: SoA planes of per-sample
products ``[N, A, L]`` (`/root/reference/src/benchmarks.jl:1089-1135`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

REDUCTIONS = {}


def _register(name):
    def wrap(fn):
        REDUCTIONS[name] = fn
        return fn
    return wrap


@_register("pure")
def reduce_pure(prod_re: jax.Array, prod_im: jax.Array):
    """One reduction per (I/Q, antenna, tap) component — the unfused floor.

    Mirrors `_bench_reduction` "pure" which launches `reduce_3` per component
    (`/root/reference/src/benchmarks.jl:981-1036`). Each scalar column is
    reduced in its own XLA computation, pinned apart with optimization
    barriers so XLA cannot re-fuse what the benchmark is measuring.
    """
    n, num_a, num_l = prod_re.shape
    outs_re = []
    outs_im = []
    for a in range(num_a):
        for l in range(num_l):
            col_re, col_im = jax.lax.optimization_barrier(
                (prod_re[:, a, l], prod_im[:, a, l])
            )
            outs_re.append(jnp.sum(col_re))
            outs_im.append(jnp.sum(col_im))
    acc_re = jnp.stack(outs_re).reshape(num_a, num_l)
    acc_im = jnp.stack(outs_im).reshape(num_a, num_l)
    return acc_re, acc_im


@_register("cplx")
def reduce_cplx(prod_re: jax.Array, prod_im: jax.Array):
    """I/Q fused, one reduction per (antenna, tap) — `reduce_cplx_3/4/5`."""
    n, num_a, num_l = prod_re.shape
    outs = []
    for a in range(num_a):
        for l in range(num_l):
            pair = jax.lax.optimization_barrier(
                jnp.stack([prod_re[:, a, l], prod_im[:, a, l]], axis=-1)
            )
            outs.append(jnp.sum(pair, axis=0))
    acc = jnp.stack(outs).reshape(num_a, num_l, 2)
    return acc[..., 0], acc[..., 1]


@_register("cplx_multi")
def reduce_cplx_multi(prod_re: jax.Array, prod_im: jax.Array):
    """Fully fused: both planes, all antennas and taps in one reduction —
    the `reduce_cplx_multi_*` workhorse (`/root/reference/src/reduction.jl:331-403`)."""
    return jnp.sum(prod_re, axis=0), jnp.sum(prod_im, axis=0)


def get_reduction(name: str):
    try:
        return REDUCTIONS[name]
    except KeyError:
        raise KeyError(
            f"Unknown reduction {name!r}; known: {sorted(REDUCTIONS)}"
        ) from None

"""Device-mesh construction for the distributed tracking axes.

The reference is single-process/single-GPU (SURVEY.md §1: no NCCL/MPI anywhere
in `/root/reference/Project.toml`); its only cross-block combiner is
`CUDA.@atomic` (`/root/reference/src/algorithms.jl:628-629`). The scale-out
here is a `jax.sharding.Mesh` and XLA collectives (NCCL on the GPU), with the
framework's three axes:

- ``chan``  — satellite channels (data parallel: zero communication),
- ``time``  — the sample axis of one integration block (sequence parallel:
  one tiny `psum` of ``[A, L]`` accumulators per block),
- ``ant``   — antennas (tensor-parallel-style: `psum` beamforming).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

CHAN_AXIS = "chan"
TIME_AXIS = "time"
ANT_AXIS = "ant"


def make_mesh(
    axis_sizes: Mapping[str, int],
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh with the given ``{axis_name: size}`` layout.

    Sizes must multiply to the device count used. The cards of one host are
    joined all to all (NVLink), so device order does not matter: the layout
    follows the algorithm only.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    total = int(np.prod(sizes)) if sizes else 1
    if total > len(devices):
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {total} devices, have {len(devices)}"
        )
    grid = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(grid, names)


def channel_time_mesh(
    num_chan_shards: Optional[int] = None,
    num_time_shards: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """The default production layout: channels × time-blocks.

    With only ``num_time_shards`` given, all remaining devices go to the
    channel axis (channels are communication-free, so they soak up whatever
    parallelism is left after the time axis is sized for latency).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if num_chan_shards is None:
        num_chan_shards = len(devices) // num_time_shards
    return make_mesh(
        {CHAN_AXIS: num_chan_shards, TIME_AXIS: num_time_shards}, devices
    )

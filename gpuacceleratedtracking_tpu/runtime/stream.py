"""Streaming tracking runtime: front-end IQ blocks -> on-device channel bank.

The reference benchmarks isolated 1 ms kernels on synthetic arrays; a
deployed receiver runs *continuously*. This driver closes that gap: it pulls
fixed-size sample blocks from an IQ source (`runtime.iq.IQFile` / `IQRing`),
groups them into dispatch chunks, and advances a `tracking.track_bank` scan
per chunk — the bank state pytree stays on device between dispatches, and
host work per chunk is one async dispatch plus the (tiny) output readback.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Iterator, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..tracking.state import TrackConfig, TrackOutput, TrackState
from ..tracking.track import track_bank
from . import iq as iq_mod


@dataclasses.dataclass
class StreamResult:
    """Host-side per-block observables accumulated over a streaming run."""

    outputs: list          # list of TrackOutput (stacked [B, K] per chunk)
    final_state: TrackState
    blocks_processed: int
    # Per-block wall time of each dispatch chunk (decode + transfer +
    # scan + output readback). The first entry carries the jit compile;
    # `steady_block_s` (the median) is the deployed streaming rate.
    dispatch_block_s: list = dataclasses.field(default_factory=list)

    def stacked(self) -> TrackOutput:
        return TrackOutput(*(
            np.concatenate([np.asarray(getattr(o, f)) for o in self.outputs])
            for f in TrackOutput._fields
        ))

    @property
    def steady_block_s(self) -> Optional[float]:
        # The first dispatch carries the jit compile — drop it outright, then
        # take the interpolating median of the rest (an upper-middle pick on
        # an even count would re-admit the largest entry).
        if not self.dispatch_block_s:
            return None
        rest = self.dispatch_block_s[1:]
        return statistics.median(rest) if rest else self.dispatch_block_s[0]


class StreamTracker:
    """Continuously track a channel bank over a block stream.

    ``blocks_per_dispatch`` trades latency for dispatch amortization: each
    device dispatch scans that many 1-block tracking steps (the scan is
    compiled once; state carries over between dispatches).

    ``checkpoint_path``/``checkpoint_every`` enable periodic NCO-state
    snapshots so an interrupted run resumes at block granularity (the
    closed-loop analog of the reference's per-config `@tagsave` resume,
    `/root/reference/scripts/run_benchmarks_gpsl1.jl:24-27`; SURVEY.md §5.4).

    ``measure_dispatch`` (default False) host-fences every dispatch chunk to
    time it — benchmark instrumentation only. In deployment leave it off:
    the fence serializes chunk i's device compute against chunk i+1's IQ
    decode/stacking, so the production path stays one async dispatch of host
    work per chunk and `dispatch_block_s` stays empty.
    """

    def __init__(
        self,
        config: TrackConfig,
        codes,
        states: TrackState,
        blocks_per_dispatch: int = 20,
        checkpoint_path=None,
        checkpoint_every: int = 200,
        measure_dispatch: bool = False,
    ):
        self.config = config
        self.codes = jnp.asarray(codes)
        self.states = states
        self.blocks_per_dispatch = blocks_per_dispatch
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.measure_dispatch = measure_dispatch
        self._since_checkpoint = 0

    def save_checkpoint(self, blocks_done: int) -> None:
        if self.checkpoint_path is None:
            return
        leaves, treedef = jax.tree.flatten(self.states)
        np.savez(
            self.checkpoint_path,
            blocks_done=np.int64(blocks_done),
            **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)},
        )

    def load_checkpoint(self) -> int:
        """Restore states from the checkpoint; returns blocks already done."""
        data = np.load(self.checkpoint_path)
        leaves, treedef = jax.tree.flatten(self.states)
        restored = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
        self.states = jax.tree.unflatten(treedef, restored)
        return int(data["blocks_done"])

    def process(self, sre: np.ndarray, sim: np.ndarray) -> TrackOutput:
        """Process ``[B, N]`` blocks; returns per-block outputs ``[B, K]``."""
        self.states, out = track_bank(
            self.config, self.codes, self.states,
            jnp.asarray(sre), jnp.asarray(sim),
        )
        return out

    def run(self, source: Iterator, max_blocks: Optional[int] = None) -> StreamResult:
        """Drain an iterator of ``(re, im)`` block pairs (e.g. `blocks()`)."""
        n = self.config.num_samples
        chunk_re, chunk_im, outputs, processed = [], [], [], 0
        dispatch_block_s = []

        def dispatch():
            nonlocal processed
            b = len(chunk_re)
            t0 = time.perf_counter()
            out = self.process(np.stack(chunk_re), np.stack(chunk_im))
            if self.measure_dispatch:
                # Benchmark-only fence: blocks the host for the chunk's
                # device compute.
                jax.block_until_ready(out)
                dispatch_block_s.append((time.perf_counter() - t0) / b)
            outputs.append(out)
            processed += b

        for re, im in source:
            if re.shape[-1] != n:
                break  # short tail block at EOF
            chunk_re.append(re)
            chunk_im.append(im)
            if len(chunk_re) == self.blocks_per_dispatch:
                dispatch()
                self._since_checkpoint += len(chunk_re)
                chunk_re, chunk_im = [], []
                if self._since_checkpoint >= self.checkpoint_every:
                    self.save_checkpoint(processed)
                    self._since_checkpoint = 0
            if max_blocks is not None and processed >= max_blocks:
                break
        if chunk_re:
            dispatch()
        return StreamResult(outputs, self.states, processed, dispatch_block_s)


def blocks(source: "iq_mod.IQFile", num_samples: int):
    """Iterate SoA blocks of ``num_samples`` from an IQ file until EOF."""
    while True:
        re, im = source.read(num_samples)
        if re.size == 0:
            return
        yield re, im


def track_file(
    config: TrackConfig,
    codes,
    states: TrackState,
    path,
    fmt: str = "int8",
    scale: float = 1.0,
    blocks_per_dispatch: int = 20,
    max_blocks: Optional[int] = None,
) -> StreamResult:
    """Track a channel bank straight off a raw IQ capture file."""
    tracker = StreamTracker(config, codes, states, blocks_per_dispatch)
    with iq_mod.IQFile(path, fmt, scale) as f:
        return tracker.run(blocks(f, config.num_samples), max_blocks)

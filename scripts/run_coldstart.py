#!/usr/bin/env python
"""Cold-start end-to-end demo: int8 IQ captures -> native C++ decode ->
PCPS acquisition -> secondary-code sync -> closed-loop tracking -> observables.

The reference benchmarks the correlation kernel in isolation; the ecosystem
around it (Acquisition.jl -> Tracking.jl handoff, `/root/reference/src/
benchmarks.jl:54`) is what a receiver actually runs. This script exercises
that full pipeline on this framework, from raw int8 bytes to navigation
observables, with no prior knowledge injected beyond the PRN search list:

  1. synthesize deterministic int8 captures (seeded AWGN, quantized like an
     RF front end): GPS L1 C/A band at 8.192 MHz with 4 satellites, and a
     GPS L5 band at 32.768 MHz with 2 satellites (I5 data x NH10 x 100 sps
     nav symbols + quadrature Q5 pilot x NH20);
  2. decode blocks through `runtime.iq.IQFile` (native C++ `libiqstream`);
  3. PCPS-acquire (noncoherent rounds) over candidate PRNs, accept by
     deflection metric;
  4. L1: closed-loop bank track via `runtime.stream.StreamTracker`,
     demonstrating the checkpoint/resume path mid-run;
  5. L5: pilot-only pull-in -> `tracking.secondary.detect_secondary_offset`
     (NH20 sync) -> dual-component (pilot-driven) track + nav-symbol
     demodulation;
  6. B1I (BeiDou D1, no pilot to lean on): Costas pull-in -> data-robust
     NH20 sync (best-of-20 bit-aligned windows — D1 aligns nav-bit edges to
     NH cycles) -> NH-wiped track + 50 bps nav-bit demodulation;
  7. write `data/coldstart/observables.json` + `img/coldstart_pipeline.png`.

Run on the default backend; pass --cpu to force the CPU backend.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

ROOT = pathlib.Path(__file__).parent.parent
OUT_DATA = ROOT / "data" / "coldstart"
OUT_IMG = ROOT / "img"

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="force CPU backend")
parser.add_argument("--capture-dir", default=str(ROOT / "data" / "coldstart"
                                                   / "captures"))
ARGS = parser.parse_args()

import jax

if ARGS.cpu:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

# Capture synthesis runs on the host CPU backend: it only writes files.
_CPU = jax.local_devices(backend="cpu")[0]

from gpuacceleratedtracking_tpu.acquire import acquire, to_track_states
from gpuacceleratedtracking_tpu.models import (
    BeiDouB1I, GPSL1, GPSL5, gen_signal,
)
from gpuacceleratedtracking_tpu.runtime import IQFile, StreamTracker, blocks
from gpuacceleratedtracking_tpu.runtime import iq as iq_mod
from gpuacceleratedtracking_tpu.tracking import (
    TrackConfig,
    detect_secondary_offset,
    detect_secondary_offset_windowed,
    dual_config,
    init_state,
    track_bank,
    track_bank_dual,
)

# --- capture truth (what the script plants; reported for the reader, never
# fed to acquisition/tracking) ---
L1 = dict(
    fs=8.192e6, n=8192, ms=600, prns=[2, 7, 13, 21],
    dops=[-2400.0, -700.0, 850.0, 3100.0],
    phases=[120.0, 512.3, 41.7, 987.2],
    sigma=11.4,          # ~45 dB-Hz per satellite at 8.192 MHz
    scale=3.7,           # int8 LSBs per unit amplitude (clips at ~3 sigma)
)
L5 = dict(
    fs=32.768e6, n=32768, ms=280, prns=[4, 11],
    dops=[-1600.0, 2200.0],
    phases=[2048.0, 7777.5],
    nh_phase=[3, 7],     # planted NH overlay offsets (blocks)
    sigma=22.8,          # ~45 dB-Hz per component at 32.768 MHz
    scale=1.8,
)
# BeiDou B1I D1 (MEO/IGSO): primary x NH20 x 50 bps nav, bit edges aligned
# with the NH20 cycle per the ICD — the hard case for secondary sync, since
# there is no dataless pilot to lean on (unlike L5's Q5).
B1I = dict(
    fs=8.192e6, n=8192, ms=400, prns=[8, 25],
    dops=[-1800.0, 950.0],
    phases=[333.4, 1402.1],
    nh_phase=[5, 12],
    sigma=11.4,          # ~45 dB-Hz per satellite at 8.192 MHz
    scale=3.7,
)


def synthesize_l1(path: pathlib.Path) -> None:
    system = GPSL1()
    total = None
    ctx = jax.default_device(_CPU)
    ctx.__enter__()
    for prn, dop, phi in zip(L1["prns"], L1["dops"], L1["phases"]):
        scale = 1.0 + dop / system.center_frequency
        s, _ = gen_signal(
            system, prn, dop, L1["n"] * L1["ms"], duration=L1["ms"] * 1e-3,
            start_code_phase=phi, code_frequency=system.code_frequency * scale,
        )
        total = s if total is None else total + s
    _write_int8(path, np.asarray(total), L1["sigma"], L1["scale"], seed=11)
    ctx.__exit__(None, None, None)


def synthesize_l5(path: pathlib.Path) -> None:
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    ctx = jax.default_device(_CPU)
    ctx.__enter__()
    rng = np.random.default_rng(55)
    nav = np.repeat(rng.choice([-1.0, 1.0], L5["ms"] // 10), 10)
    total = None
    for prn, dop, phi, nh0 in zip(
        L5["prns"], L5["dops"], L5["phases"], L5["nh_phase"]
    ):
        scale = 1.0 + dop / sys_i.center_frequency
        common = dict(
            duration=L5["ms"] * 1e-3, start_code_phase=phi,
            code_frequency=sys_i.code_frequency * scale,
        )
        # data component: primary x NH10 x nav symbols, as one composite
        # per-period overlay (period p sign = NH10[(p + nh0) % 10] * nav[p])
        nh10 = np.asarray(sys_i.secondary_code, np.float32)
        overlay = nh10[(np.arange(L5["ms"]) + nh0) % 10] * nav
        s_i, _ = gen_signal(sys_i, prn, dop, L5["n"] * L5["ms"],
                            secondary_code=overlay, **common)
        # pilot: quadrature carrier, NH20 at the same planted offset
        s_q, _ = gen_signal(sys_q, prn, dop, L5["n"] * L5["ms"],
                            secondary_code=sys_q.secondary_code,
                            secondary_phase=nh0,
                            start_carrier_phase=np.pi / 2, **common)
        s = np.asarray(s_i) + np.asarray(s_q)
        total = s if total is None else total + s
    _write_int8(path, total, L5["sigma"], L5["scale"], seed=56)
    ctx.__exit__(None, None, None)


def synthesize_b1i(path: pathlib.Path) -> None:
    system = BeiDouB1I(with_secondary=False)
    nh20 = np.asarray(BeiDouB1I().secondary_code, np.float32)
    ctx = jax.default_device(_CPU)
    ctx.__enter__()
    rng = np.random.default_rng(77)
    total = None
    for prn, dop, phi, nh0 in zip(
        B1I["prns"], B1I["dops"], B1I["phases"], B1I["nh_phase"]
    ):
        scale = 1.0 + dop / system.center_frequency
        # D1 structure: one 20 ms nav bit per NH20 cycle, bit edges ON the
        # cycle boundary (ICD) — block p carries NH20[(p+nh0)%20] * bit.
        bits = rng.choice([-1.0, 1.0], B1I["ms"] // 20 + 2)
        overlay = (nh20[(np.arange(B1I["ms"]) + nh0) % 20]
                   * bits[(np.arange(B1I["ms"]) + nh0) // 20])
        s, _ = gen_signal(
            system, prn, dop, B1I["n"] * B1I["ms"],
            duration=B1I["ms"] * 1e-3, start_code_phase=phi,
            code_frequency=system.code_frequency * scale,
            secondary_code=overlay,
        )
        total = s if total is None else total + s
    _write_int8(path, np.asarray(total), B1I["sigma"], B1I["scale"], seed=78)
    ctx.__exit__(None, None, None)


def _write_int8(path, signal, sigma, scale, seed):
    """Quantize complex f32 + AWGN to interleaved int8 (front-end model)."""
    rng = np.random.default_rng(seed)
    re = np.real(signal) + sigma * rng.standard_normal(signal.shape)
    im = np.imag(signal) + sigma * rng.standard_normal(signal.shape)
    inter = np.empty(2 * signal.size, np.float32)
    inter[0::2] = re * scale
    inter[1::2] = im * scale
    np.clip(np.rint(inter), -127, 127).astype(np.int8).tofile(path)


def _track_chunked(step_fn, states, path, n, count, start_block, scale,
                   chunk=40):
    """Run a scan-style tracker over file blocks in bounded dispatches.

    A deployed receiver streams: feed ``chunk`` blocks per dispatch, carry
    the bank state between dispatches, stack the outputs on the host.
    """
    outs = []
    done = 0
    dispatch_s = []
    while done < count:
        b = min(chunk, count - done)
        sre, sim = read_blocks(path, n, b, start_block + done, scale)
        t0 = time.perf_counter()
        states, out = step_fn(states, jnp.asarray(sre), jnp.asarray(sim))
        jax.block_until_ready(out)
        dispatch_s.append((time.perf_counter() - t0) / b)
        outs.append(out)
        done += b
    stacked = jax.tree.map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *outs
    )
    # Median per-block dispatch time = steady-state streaming rate (the
    # first dispatch carries the jit compile; median rejects it).
    steady = float(np.median(dispatch_s)) if dispatch_s else None
    return states, stacked, steady


def read_blocks(path, n, count, start_block=0, scale=1.0):
    with IQFile(path, "int8", scale) as f:
        f.read(start_block * n)
        out = [f.read(n) for _ in range(count)]
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


def acquire_band(system, path, n, fs, rounds=6, accept=20.0,
                 doppler_step=150.0):
    # accept=20: the noise-only deflection maximum over this search grid sits
    # near sqrt(2 ln(D N)) ~ 5 and C/A cross-correlation impostors reach ~10
    # at strong planted power (measured 9.4); planted satellites read >= ~40.
    sre, sim = read_blocks(path, n, rounds)
    # 150 Hz bins: the default 2/(3T) grid leaves up to ~333 Hz of initial
    # Doppler error, which costs most of a second of PLL pull-in time.
    # PCPS runs on the default backend through jnp.fft.
    res = acquire(system, jnp.asarray(sre), jnp.asarray(sim),
                  np.arange(system.codes.shape[1]), fs,
                  doppler_step=doppler_step)
    res = jax.tree.map(np.asarray, res)
    metric = np.asarray(res.peak_metric)
    hits = np.flatnonzero(metric > accept)
    return res, hits


def run_l1(capture: pathlib.Path, report: dict) -> dict:
    system = GPSL1()
    res, hits = acquire_band(system, capture, L1["n"], L1["fs"])
    report["l1_acquisition"] = {
        "engine": "fft",
        "searched_prns": int(system.codes.shape[1]),
        "accepted": [
            {
                "prn": int(p),
                "doppler_hz": float(np.asarray(res.carrier_doppler)[p]),
                "code_phase_chips": float(np.asarray(res.code_phase)[p]),
                "metric": float(np.asarray(res.peak_metric)[p]),
            }
            for p in hits
        ],
        "planted": [
            {"prn": p, "doppler_hz": d}
            for p, d in zip(L1["prns"], L1["dops"])
        ],
    }
    assert sorted(int(p) for p in hits) == sorted(L1["prns"]), (
        f"acquisition found {hits}, planted {L1['prns']}"
    )

    sub = jax.tree.map(lambda x: np.asarray(x)[hits], res)
    states = to_track_states(sub)
    config = TrackConfig.for_system(system, L1["fs"], L1["n"])
    ckpt = OUT_DATA / "l1_checkpoint.npz"
    tracker = StreamTracker(
        config, system.codes, states, blocks_per_dispatch=60,
        checkpoint_path=ckpt, checkpoint_every=100, measure_dispatch=True,
    )
    # First leg: track half the capture, checkpointing along the way ...
    t_track = time.perf_counter()
    with IQFile(capture, "int8", 1.0 / L1["scale"]) as f:
        first = tracker.run(blocks(f, L1["n"]), max_blocks=L1["ms"] // 2)
    tracker.save_checkpoint(first.blocks_processed)
    # ... then COLD-RESUME: a brand-new tracker restores NCO state from the
    # checkpoint file and continues where the first process stopped.
    tracker2 = StreamTracker(
        config, system.codes, init_state(np.asarray(states.prn)),
        blocks_per_dispatch=60, checkpoint_path=ckpt, measure_dispatch=True,
    )
    done = tracker2.load_checkpoint()
    with IQFile(capture, "int8", 1.0 / L1["scale"]) as f:
        f.read(done * L1["n"])
        second = tracker2.run(blocks(f, L1["n"]))
    track_wall = time.perf_counter() - t_track
    out1, out2 = first.stacked(), second.stacked()
    dop = np.concatenate([np.asarray(out1.carrier_doppler),
                          np.asarray(out2.carrier_doppler)])
    cn0 = np.concatenate([np.asarray(out1.cn0_dbhz),
                          np.asarray(out2.cn0_dbhz)])
    dop_err = dop[-20:].mean(axis=0) - np.asarray(
        [d for _, d in sorted(zip(L1["prns"], L1["dops"]))]
    )
    n_blocks = int(first.blocks_processed + second.blocks_processed)
    steady = [t for r in (first, second) for t in r.dispatch_block_s]
    steady_med = sorted(steady)[len(steady) // 2] if steady else None
    report["l1_track"] = {
        "blocks": n_blocks,
        # Realized streaming throughput (includes native IQ decode and
        # per-chunk host->device transfer — the deployed-receiver path).
        # Wall time absorbs jit compiles; the per-dispatch MEDIAN is the
        # steady streaming rate.
        "track_wall_s": track_wall,
        "blocks_per_s": n_blocks / track_wall,
        "realtime_factor": n_blocks * 1e-3 / track_wall,
        "steady_block_s": steady_med,
        "steady_realtime_factor": 1e-3 / steady_med if steady_med else None,
        "resume_at_block": int(done),
        "final_doppler_hz": [float(x) for x in dop[-20:].mean(axis=0)],
        "doppler_error_hz": [float(x) for x in dop_err],
        "final_cn0_dbhz": [float(x) for x in cn0[-20:].mean(axis=0)],
    }
    assert np.all(np.abs(dop_err) < 10.0), dop_err
    return {"doppler": dop, "cn0": cn0}


def run_l5(capture: pathlib.Path, report: dict) -> dict:
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    scale = 1.0 / L5["scale"]
    # Acquire on the PILOT code (dataless component; NH flips between the
    # 1 ms rounds are absorbed by noncoherent integration).
    # 50 Hz bins + 16 noncoherent rounds: at this C/N0 the 150 Hz grid's
    # argmax lands up to 1.5 bins (~230 Hz) off under noise — beyond what the
    # 120-block pilot pull-in before NH20 sync can absorb. A 50 Hz grid
    # measured <=50 Hz error on this capture (both satellites).
    res, hits = acquire_band(sys_q, capture, L5["n"], L5["fs"], rounds=16,
                             doppler_step=50.0)
    report["l5_acquisition"] = {
        "engine": "fft",
        "accepted": [
            {
                "prn": int(p),
                "doppler_hz": float(np.asarray(res.carrier_doppler)[p]),
                "metric": float(np.asarray(res.peak_metric)[p]),
            }
            for p in hits
        ],
        "planted": [
            {"prn": p, "doppler_hz": d}
            for p, d in zip(L5["prns"], L5["dops"])
        ],
    }
    assert sorted(int(p) for p in hits) == sorted(L5["prns"]), hits

    sub = jax.tree.map(lambda x: np.asarray(x)[hits], res)
    states = to_track_states(sub)
    # Stage 1 — pilot pull-in, overlay-agnostic (Costas tolerates the NH
    # sign flips), to collect prompts for secondary sync. Carrier PHASE must
    # settle before the prompt signs are NH-stable: ~100 ms from the ~75 Hz
    # acquisition bin error at this C/N0.
    sync_blocks = 160
    cfg_sync = TrackConfig.for_system(
        sys_q, L5["fs"], L5["n"], use_secondary=False,
    )
    st1, out1, _ = _track_chunked(
        lambda st, a, b: track_bank(
            cfg_sync, jnp.asarray(sys_q.codes), st, a, b
        ),
        states, capture, L5["n"], sync_blocks, 0, scale,
    )
    # Stage 2 — NH20 sync from the locked prompts (skip the pull-in
    # transient), then align the block counter so overlay wipe-off is in
    # phase for the dual-component tracker.
    # Measured on this capture: the 50 Hz-error channel phase-locks by block
    # ~110 (sign-match 40/40 from block 120); windows after that read conf ~1.0.
    settle = 100
    offset, conf = detect_secondary_offset(
        jnp.asarray(np.asarray(out1.prompt_re)[settle:]),
        sys_q.secondary_code,
    )
    offset = (np.asarray(offset) - settle) % len(sys_q.secondary_code)
    report["l5_secondary_sync"] = {
        "nh20_offset_blocks": [int(o) for o in offset],
        "planted_offset": [
            o for _, o in sorted(zip(L5["prns"], L5["nh_phase"]))
        ],
        "confidence": [float(c) for c in np.asarray(conf)],
    }
    assert np.all(np.asarray(conf) > 0.75), (
        f"NH20 sync not confident: {np.asarray(conf)} — pilot not settled"
    )
    st_dual = st1._replace(
        ms_elapsed=jnp.asarray(sync_blocks + offset, jnp.int32)
    )
    # Stage 3 — dual-component track of the rest of the capture: pilot-driven
    # atan2 loop + data-component nav-symbol demodulation.
    cfg_dual = dual_config(cfg_sync)
    rest = L5["ms"] - sync_blocks
    t_track = time.perf_counter()
    st2, out2, steady_block_s = _track_chunked(
        lambda st, a, b: track_bank_dual(
            cfg_dual, jnp.asarray(sys_i.codes), jnp.asarray(sys_q.codes),
            st, a, b,
        ),
        st_dual, capture, L5["n"], rest, sync_blocks, scale,
    )
    track_wall = time.perf_counter() - t_track
    dop = np.asarray(out2.pilot.carrier_doppler)
    planted = np.asarray([d for _, d in sorted(zip(L5["prns"], L5["dops"]))])
    dop_err = dop[-20:].mean(axis=0) - planted
    # Nav symbols: 100 sps = 10 blocks/symbol; decide from block sums of the
    # wiped data prompts over whole symbol windows.
    d = np.asarray(out2.data_prompt_re)
    symbols = {}
    for ch in range(d.shape[1]):
        s0 = int((10 - (sync_blocks % 10)) % 10)
        dd = d[s0:, ch]
        dd = dd[: len(dd) // 10 * 10].reshape(-1, 10).sum(axis=1)
        symbols[ch] = np.sign(dd).astype(int).tolist()
    report["l5_dual_track"] = {
        "blocks": int(rest),
        "track_wall_s": track_wall,
        "blocks_per_s": rest / track_wall,
        "realtime_factor": rest * 1e-3 / track_wall,
        # Steady-state per-block dispatch (median; first dispatch carries
        # the jit compile) — the deployed streaming rate.
        "steady_block_s": steady_block_s,
        "steady_realtime_factor": (
            1e-3 / steady_block_s if steady_block_s else None
        ),
        "final_doppler_hz": [float(x) for x in dop[-20:].mean(axis=0)],
        "doppler_error_hz": [float(x) for x in dop_err],
        "final_cn0_dbhz": [
            float(x)
            for x in np.asarray(out2.pilot.cn0_dbhz)[-20:].mean(axis=0)
        ],
        "nav_symbols_last10": {k: v[-10:] for k, v in symbols.items()},
        "pilot_prompt_final": [
            float(x) for x in np.asarray(out2.pilot.prompt_re)[-1]
        ],
    }
    assert np.all(np.abs(dop_err) < 10.0), dop_err
    return {"doppler": dop, "pilot_prompt": np.asarray(out2.pilot.prompt_re),
            "data_prompt": d}


def run_b1i(capture: pathlib.Path, report: dict) -> dict:
    system = BeiDouB1I(with_secondary=False)
    sys_nh = BeiDouB1I()
    scale = 1.0 / B1I["scale"]
    # NH20 flips the 1 ms blocks' signs; 16 NONcoherent rounds are immune
    # to them (same trick as the L5 pilot leg's 50 Hz grid).
    res, hits = acquire_band(system, capture, B1I["n"], B1I["fs"], rounds=16,
                             doppler_step=50.0)
    report["b1i_acquisition"] = {
        "engine": "fft",
        "searched_prns": int(system.codes.shape[1]),
        "accepted": [
            {
                "prn": int(p),
                "doppler_hz": float(np.asarray(res.carrier_doppler)[p]),
                "metric": float(np.asarray(res.peak_metric)[p]),
            }
            for p in hits
        ],
        "planted": [
            {"prn": p, "doppler_hz": d}
            for p, d in zip(B1I["prns"], B1I["dops"])
        ],
    }
    assert sorted(int(p) for p in hits) == sorted(B1I["prns"]), hits

    sub = jax.tree.map(lambda x: np.asarray(x)[hits], res)
    states = to_track_states(sub)
    # Stage 1 — Costas pull-in, overlay-agnostic (NH20 x nav sign flips are
    # invisible to the dot/atan discriminators).
    sync_blocks = 180
    cfg_sync = TrackConfig.for_system(
        system, B1I["fs"], B1I["n"], use_secondary=False,
    )
    st1, out1, _ = _track_chunked(
        lambda st, a, b: track_bank(
            cfg_sync, jnp.asarray(system.codes), st, a, b
        ),
        states, capture, B1I["n"], sync_blocks, 0, scale,
    )
    # Stage 2 — NH20 sync WITHOUT a pilot: nav bits flip whole NH cycles,
    # so a window straddling a bit edge decorrelates. D1 aligns bit edges
    # to NH cycle boundaries (ICD), so among 20 window phases at least one
    # is bit-clean — `detect_secondary_offset_windowed` takes, per channel,
    # the phase with max confidence.
    settle = 120
    P = np.asarray(out1.prompt_re)        # [B, K]
    sc = np.asarray(sys_nh.secondary_code, np.float32)
    off, conf = detect_secondary_offset_windowed(
        jnp.asarray(P[settle:]), sc
    )
    best_off = (np.asarray(off) - settle) % 20
    best_conf = np.asarray(conf)
    # Fixed N-sample tracker blocks vs the code period: a channel whose code
    # phase sits PAST half a period has its NH boundary mid-block, so the
    # block-dominant overlay sign is the NEXT period's — the correct wipe-off
    # offset is then nh0+1 (and that channel pays an amplitude haircut on
    # blocks where adjacent overlay signs differ; visible as a few dB of
    # C/N0). Real effect of block-aligned (vs code-rollover-aligned)
    # integration; encoded explicitly:
    planted_off = [o for _, o in sorted(zip(B1I["prns"], B1I["nh_phase"]))]
    phases_sorted = [p for _, p in sorted(zip(B1I["prns"], B1I["phases"]))]
    expected_off = [
        (o + (1 if ph > system.code_length / 2 else 0)) % 20
        for o, ph in zip(planted_off, phases_sorted)
    ]
    report["b1i_secondary_sync"] = {
        "nh20_offset_blocks": [int(o) for o in best_off],
        "planted_offset": planted_off,
        "expected_offset_block_dominant": expected_off,
        "confidence": [float(c) for c in best_conf],
    }
    assert [int(o) for o in best_off] == expected_off, (
        best_off, expected_off)
    assert np.all(best_conf > 0.75), (
        f"NH20 sync not confident: {best_conf}"
    )
    # Stage 3 — NH-wiped track of the rest; residual prompt sign IS the
    # 50 bps nav bit (one per NH cycle).
    st2_init = st1._replace(
        ms_elapsed=jnp.asarray(sync_blocks + best_off, jnp.int32)
    )
    cfg_track = TrackConfig.for_system(sys_nh, B1I["fs"], B1I["n"])
    rest = B1I["ms"] - sync_blocks
    t_track = time.perf_counter()
    st2, out2, steady_block_s = _track_chunked(
        lambda st, a, b: track_bank(
            cfg_track, jnp.asarray(sys_nh.codes), st, a, b
        ),
        st2_init, capture, B1I["n"], rest, sync_blocks, scale,
    )
    track_wall = time.perf_counter() - t_track
    dop = np.asarray(out2.carrier_doppler)
    planted = np.asarray([d for _, d in sorted(zip(B1I["prns"], B1I["dops"]))])
    dop_err = dop[-20:].mean(axis=0) - planted
    # Nav bits: 20 blocks/bit, edges where (block + nh0) % 20 == 0.
    d = np.asarray(out2.prompt_re)
    symbols = {}
    for ch in range(d.shape[1]):
        s0 = int((20 - (sync_blocks + best_off[ch]) % 20) % 20)
        dd = d[s0:, ch]
        dd = dd[: len(dd) // 20 * 20].reshape(-1, 20).sum(axis=1)
        symbols[ch] = np.sign(dd).astype(int).tolist()
    report["b1i_track"] = {
        "blocks": int(rest),
        "track_wall_s": track_wall,
        "blocks_per_s": rest / track_wall,
        "realtime_factor": rest * 1e-3 / track_wall,
        "steady_block_s": steady_block_s,
        "steady_realtime_factor": (
            1e-3 / steady_block_s if steady_block_s else None
        ),
        "final_doppler_hz": [float(x) for x in dop[-20:].mean(axis=0)],
        "doppler_error_hz": [float(x) for x in dop_err],
        "final_cn0_dbhz": [
            float(x) for x in np.asarray(out2.cn0_dbhz)[-20:].mean(axis=0)
        ],
        "nav_bits_last10": {k_: v[-10:] for k_, v in symbols.items()},
    }
    assert np.all(np.abs(dop_err) < 10.0), dop_err
    return {"doppler": dop, "prompt": d}


def make_figure(l1, l5, b1i=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ncols = 3 if b1i is None else 4
    fig, axes = plt.subplots(1, ncols, figsize=(13 if ncols == 3 else 17,
                                                3.6))
    t1 = np.arange(l1["doppler"].shape[0])
    for ch in range(l1["doppler"].shape[1]):
        axes[0].plot(t1, l1["doppler"][:, ch], lw=0.8,
                     label=f"PRN {sorted(L1['prns'])[ch] + 1}")
    for d in L1["dops"]:
        axes[0].axhline(d, color="k", lw=0.4, ls=":")
    axes[0].set(title="L1 bank: Doppler pull-in (int8 capture)",
                xlabel="block (ms)", ylabel="Doppler (Hz)")
    axes[0].legend(fontsize=7)
    axes[1].plot(t1, l1["cn0"], lw=0.8)
    axes[1].axhline(45.0, color="k", lw=0.4, ls=":")
    axes[1].set(title="L1 C/N0 estimate", xlabel="block (ms)",
                ylabel="C/N0 (dB-Hz)")
    t5 = np.arange(l5["data_prompt"].shape[0])
    axes[2].plot(t5, l5["pilot_prompt"][:, 0], lw=0.8, label="pilot I")
    axes[2].plot(t5, l5["data_prompt"][:, 0], lw=0.8, label="data I (nav)")
    axes[2].set(title="L5 dual: pilot lock + nav symbols",
                xlabel="block (ms)", ylabel="prompt")
    axes[2].legend(fontsize=7)
    if b1i is not None:
        tb = np.arange(b1i["prompt"].shape[0])
        for ch in range(b1i["prompt"].shape[1]):
            axes[3].plot(tb, b1i["prompt"][:, ch], lw=0.8,
                         label=f"PRN {sorted(B1I['prns'])[ch] + 1}")
        axes[3].set(title="B1I: NH20-wiped prompts (50 bps nav bits)",
                    xlabel="block (ms)", ylabel="prompt")
        axes[3].legend(fontsize=7)
    fig.tight_layout()
    OUT_IMG.mkdir(parents=True, exist_ok=True)
    fig.savefig(OUT_IMG / "coldstart_pipeline.png", dpi=130)


if __name__ == "__main__":
    cap_dir = pathlib.Path(ARGS.capture_dir)
    cap_dir.mkdir(parents=True, exist_ok=True)
    OUT_DATA.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    l1_path = cap_dir / "gpsl1_8192kHz.int8"
    l5_path = cap_dir / "gpsl5_32768kHz.int8"
    b1i_path = cap_dir / "bdsb1i_8192kHz.int8"
    if not l1_path.exists():
        synthesize_l1(l1_path)
    if not l5_path.exists():
        synthesize_l5(l5_path)
    if not b1i_path.exists():
        synthesize_b1i(b1i_path)
    report = {
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "native_iq_decoder": iq_mod.native_available(),
        "captures": {
            "l1": {"path": str(l1_path), "bytes": l1_path.stat().st_size,
                   "fs_hz": L1["fs"], "ms": L1["ms"]},
            "l5": {"path": str(l5_path), "bytes": l5_path.stat().st_size,
                   "fs_hz": L5["fs"], "ms": L5["ms"]},
            "b1i": {"path": str(b1i_path),
                    "bytes": b1i_path.stat().st_size,
                    "fs_hz": B1I["fs"], "ms": B1I["ms"]},
        },
    }
    # IQFile applies the inverse front-end scale during decode.
    l1_curves = run_l1(l1_path, report)
    l5_curves = run_l5(l5_path, report)
    b1i_curves = run_b1i(b1i_path, report)
    report["wall_s"] = time.time() - t0
    (OUT_DATA / "observables.json").write_text(json.dumps(report, indent=1))
    make_figure(l1_curves, l5_curves, b1i_curves)
    print(json.dumps(report, indent=1))

"""Benchmark: active voxel-updates/s for a FULL solver step on a
256^3-class sparse rising plume (BASELINE.json north-star).

Prints one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Timing: the step is compiled and run ``WARMUP`` times outside the window
(compile seconds reported separately), then ``STEPS`` donated steps run
back to back and the window ends in ``block_until_ready``. A compile
inside the window is an error, not a number.

Baseline: the reference publishes no numbers (BASELINE.md), so we use its
own bytes/voxel bandwidth model (`/root/reference/src/Cuda/Utils.cuh:260-269`
with the per-kernel constants from HNanoSolver.cu) evaluated at the memory
bandwidth of an RTX-class GPU (RTX 4090, ~1008 GB/s): the speed-of-light
throughput the CUDA implementation could reach if perfectly bandwidth-bound.
With ITERATIONS=50 pressure sweeps that model gives
  3324 bytes/voxel  ->  ~303 M voxel-updates/s.
``vs_baseline`` is (our measured voxel-updates/s) / (that envelope).

Needs a GPU: with no GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

ITERATIONS = 50  # pressure sweeps per step (the hot loop, SURVEY §3.1)
RTX_CLASS_GBPS = 1008.0  # RTX 4090 memory bandwidth
WARMUP = 3  # steps run before the window (the first one compiles)
STEPS = 20  # steps inside the timed window
METRIC = "active_voxel_updates_per_sec_full_step_256plume"


def build_plume_envelope(radius_vox=64, height_vox=256, center_x=128, center_z=128):
    """Tile set for a developed plume: emitter sphere + rising column."""
    from hnanosolver_tpu.core import coords as C

    r_t = radius_vox // C.LEAF
    h_t = height_vox // C.LEAF
    cx, cz = center_x // C.LEAF, center_z // C.LEAF
    tiles = []
    for y in range(h_t):
        # column widens slightly with height (plume cone)
        rr = r_t * (0.6 + 0.4 * y / max(h_t - 1, 1))
        for x in range(cx - r_t, cx + r_t + 1):
            for z in range(cz - r_t, cz + r_t + 1):
                if (x - cx) ** 2 + (z - cz) ** 2 <= rr * rr:
                    tiles.append((x, y, z))
    return np.array(tiles, np.int32)


def envelope_topology(radius_vox=64, height_vox=256):
    """The bench envelope's topology, capacity sized tightly (to a multiple
    of 512 tiles) since the envelope is the final developed domain."""
    from hnanosolver_tpu.core.topology import build_topology

    tiles = build_plume_envelope(radius_vox, height_vox)
    n = len(np.unique(tiles, axis=0))
    return build_topology(tiles, capacity=((n + 1 + 511) // 512) * 512)


def timed_window(step, state, jitted=None, steps=STEPS, warmup=WARMUP):
    """Run ``state = step(state)`` ``warmup`` times, then ``steps`` times
    inside a window that ends in ``block_until_ready``. ``step`` may donate
    its argument; ``jitted`` is the jitted function it calls, whose
    ``_cache_size()`` counts compiled variants (None for an ahead-of-time
    compiled ``step``, which cannot recompile). Returns (state, compile_s,
    seconds_per_step, compiles_in_window); compile_s is the first warm-up
    call's wall time."""
    import jax

    t0 = time.perf_counter()
    state = jax.block_until_ready(step(state))
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        state = step(state)
    state = jax.block_until_ready(state)
    def n_compiled():
        return 0 if jitted is None else jitted._cache_size()

    before = n_compiled()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    state = jax.block_until_ready(state)
    per_step = (time.perf_counter() - t0) / steps
    return state, compile_s, per_step, n_compiled() - before


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        sys.exit(1)

    from hnanosolver_tpu.config import SolverParams
    from hnanosolver_tpu.fields import zeros_state
    from hnanosolver_tpu.models.plume import PlumeConfig, plume_step_donated
    from hnanosolver_tpu.utils.timers import full_step_bytes_per_voxel

    params = SolverParams(dt=1.0 / 24.0, iterations=ITERATIONS, voxel_size=0.5)
    cfg = PlumeConfig(center=(128.0, 24.0, 128.0), radius=20.0)
    topo = envelope_topology()
    state, compile_s, t, n_compiles = timed_window(
        lambda s: plume_step_donated(topo, s, params, cfg), zeros_state(topo),
        plume_step_donated)
    if n_compiles:
        print(f"{n_compiles} compile(s) inside the timed window", file=sys.stderr)
        sys.exit(1)
    if not np.isfinite(np.asarray(state.velocity)).all():
        print("non-finite velocity after the window", file=sys.stderr)
        sys.exit(1)

    bpv = full_step_bytes_per_voxel(ITERATIONS)
    voxels = topo.num_voxels
    vups = voxels / t
    print(json.dumps({
        "metric": METRIC,
        "value": vups,
        "unit": "voxel_updates/s/chip",
        "vs_baseline": vups / (RTX_CLASS_GBPS * 1e9 / bpv),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "step_ms": t * 1e3,
        "compile_s": compile_s,
        "steps_timed": STEPS,
        "active_tiles": int(topo.n_active),
        "active_voxels": voxels,
        "capacity_tiles": topo.capacity,
        "pressure_iterations": ITERATIONS,
        "peak_bytes_in_use": dev.memory_stats().get("peak_bytes_in_use"),
    }))


if __name__ == "__main__":
    main()

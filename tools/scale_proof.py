"""Scale proof: slab-sharded step at production tile counts on a virtual
8-device CPU mesh, asserted against the single-device step (a toy-size
mesh check leaves production tile counts unproven).

Usage: python tools/scale_proof.py [n_tiles] [iterations]
Writes a summary line per check.
"""

from __future__ import annotations

import os
import sys
import time


def main(target_tiles: int = 20_000, iterations: int = 4,
         height_vox: int = 512):
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from hnanosolver_tpu.config import SolverParams
    from hnanosolver_tpu.core.layout import positions_flat
    from hnanosolver_tpu.core.topology import active_mask, build_topology
    from hnanosolver_tpu.fields import zeros_state
    from hnanosolver_tpu.models.plume import PlumeConfig, plume_step
    from hnanosolver_tpu.ops.multigrid import build_hierarchy
    from hnanosolver_tpu.parallel.slab import (
        build_slab_hierarchy,
        build_slabs,
        gather_state,
        scatter_state,
        sharded_plume_step,
        sharded_step,
    )
    from hnanosolver_tpu.solver import step

    # a 512^3-class plume cone: widen until >= target_tiles
    from bench import build_plume_envelope

    r = 64
    c = height_vox // 2
    tiles = build_plume_envelope(radius_vox=r, height_vox=height_vox,
                                 center_x=c, center_z=c)
    while len(tiles) < target_tiles:
        r += 8
        tiles = build_plume_envelope(radius_vox=r, height_vox=height_vox,
                                     center_x=c, center_z=c)
    topo = build_topology(tiles)
    n = int(topo.n_active)
    print(f"domain: {n} tiles = {topo.num_voxels / 1e6:.1f} M voxels, "
          f"capacity {topo.capacity}", flush=True)

    rng = np.random.default_rng(0)
    state = zeros_state(topo)
    px, py, pz = (p.astype(jnp.float32) for p in positions_flat(topo))
    m = active_mask(topo)[:, None]
    blob = jnp.exp(-((px - 256) ** 2 + (py - 96) ** 2 + (pz - 256) ** 2) / 4e3) * m
    noise = jnp.asarray(
        rng.standard_normal((3, topo.capacity, 512)).astype(np.float32) * 0.4
    ) * m[None]
    state = (state.replace(velocity=noise)
             .with_scalar("density", blob)
             .with_scalar("temperature", (23.0 + 50 * blob) * m)
             .with_scalar("fuel", 0.3 * blob))

    params = SolverParams(dt=0.15, iterations=iterations, voxel_size=0.5)
    cfg = PlumeConfig(center=(256.0, 64.0, 256.0), radius=24.0)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("x",))
    slab = build_slabs(topo, 8)
    owned = np.asarray(slab.local_mask).sum(1)
    print(f"slab balance: owned tiles per device {owned.astype(int).tolist()}",
          flush=True)

    stacked = scatter_state(topo, slab, state)

    t0 = time.perf_counter()
    want = plume_step(topo, state, params, cfg)
    jax.block_until_ready(want)
    t_single = time.perf_counter() - t0

    fn = sharded_plume_step(mesh, slab, params, cfg)
    t0 = time.perf_counter()
    got_stacked = fn(slab, stacked)
    jax.block_until_ready(got_stacked)
    t_shard = time.perf_counter() - t0
    got = gather_state(topo, slab, got_stacked)

    mb = np.asarray(active_mask(topo)).astype(bool)
    worst = 0.0
    for name in want.scalars:
        d = float(np.abs(np.asarray(got.scalars[name])[mb]
                         - np.asarray(want.scalars[name])[mb]).max())
        s = max(float(np.abs(np.asarray(want.scalars[name])[mb]).max()), 1e-30)
        worst = max(worst, d / s)
        print(f"  {name}: max rel err {d / s:.2e}")
    dv = float(np.abs(np.asarray(got.velocity)[:, mb]
                      - np.asarray(want.velocity)[:, mb]).max())
    sv = max(float(np.abs(np.asarray(want.velocity)[:, mb]).max()), 1e-30)
    worst = max(worst, dv / sv)
    print(f"  velocity: max rel err {dv / sv:.2e}")
    assert worst < 1e-4, worst
    print(f"RBGS step parity OK at {n} tiles "
          f"(single {t_single:.1f}s, sharded {t_shard:.1f}s incl. compile)",
          flush=True)

    # multigrid sharded at scale (replicated-coarse psum restriction)
    params_mg = params.replace(pressure_solver="mg", iterations=2,
                               mg_levels=2, mg_coarsest=8)
    hier = tuple(build_hierarchy(topo, 2))
    want_mg = step(topo, state, params_mg, hier)
    shier = build_slab_hierarchy(topo, slab, 2)
    fn_mg = sharded_step(mesh, slab, params_mg, hierarchy=shier)
    got_mg = gather_state(topo, slab, fn_mg(slab, stacked))

    worst = 0.0
    for name in want_mg.scalars:
        d = float(np.abs(np.asarray(got_mg.scalars[name])[mb]
                         - np.asarray(want_mg.scalars[name])[mb]).max())
        s = max(float(np.abs(np.asarray(want_mg.scalars[name])[mb]).max()), 1e-30)
        worst = max(worst, d / s)
    dv = float(np.abs(np.asarray(got_mg.velocity)[:, mb]
                      - np.asarray(want_mg.velocity)[:, mb]).max())
    worst = max(worst, dv / sv)
    assert worst < 1e-4, worst
    print(f"multigrid sharded step parity OK at {n} tiles "
          f"(max rel err {worst:.2e})", flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    it = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    h = int(sys.argv[3]) if len(sys.argv) > 3 else 512
    main(n, it, h)

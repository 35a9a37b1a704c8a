"""On-card smoke test: drives the solver's main path once on one GPU.

    python chip_smoke.py                # the phases below on one GPU
    python chip_smoke.py --four-cards   # only: slab-sharded step on 4 GPUs
                                        # vs the single-device step

Phases, one line each (``phase <name>: ok|FAILED ...``):
  (a) device      JAX's default device must be a GPU
  (b) envelope    bench envelope (4,196 tiles, 2,148,352 voxels) through
                  plume_step_donated at 50 RBGS iterations: compile seconds,
                  step ms, memory_analysis, peak bytes, finiteness, and
                  which byte-cap governors engage
  (c) parity      solver.step on a fully active 256^3 dense topology vs
                  dense.solver.step_dense on the same card
  (d) cook        hnanosolver_tpu.cli.main in-process: a growing 3-frame
                  plume written as .vdb, then a 2-frame fire
  (e) multigrid   one "mg" step (mg_tol set) at the envelope; residual
                  ratio of the MG solve beside RBGS-50 on the same RHS
  (f) kernel      solve_pressure with the Triton RBGS sweep compiled for the
                  card vs with the XLA sweep, at the envelope, 50
                  iterations: difference and times
  (g) step-ab     the full envelope step, RBGS-50 and multigrid, with each
                  sweep implementation, interleaved (the measurement that
                  keeps the kernel)
  (h) gpu-tests   the tests marked ``gpu`` (pytest, in this process)

The last stdout line is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed; the line before it is the card's
name and power limit as nvidia-smi reports them. Exits non-zero on any
failure, and when JAX finds no GPU. One process uses the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
# full-step parity tolerance: test_parity.py's 2e-4, taken relative to each
# field's maximum (temperature reaches ~30). Differences come from summation
# order and FMA contraction, which differ between the sparse and the dense
# programs and between backends.
PARITY_RTOL = 2e-4
SHARDED_RTOL = 1e-4  # sharded vs single-device step (__graft_entry__.py)
PARITY_N = 256  # edge of the fully active parity box, in voxels


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def sweep(kind: str):
    """Trace the pressure solves with the colour sweep ``kind`` ("xla" or
    "triton") in place of the platform's choice (``pressure.sweep_impl``)."""
    from hnanosolver_tpu.ops import pressure as prs

    choose = prs.sweep_impl
    prs.sweep_impl = lambda platform=None: kind
    try:
        yield
    finally:
        prs.sweep_impl = choose


def compile_with(kind: str, jitted, *args):
    """``jitted.lower(*args).compile()`` with the colour sweep ``kind``.
    ``jitted`` must be a fresh ``jax.jit`` object, so that no trace cached
    under another sweep is reused; the lowered program is checked to hold
    the Triton kernel exactly when ``kind`` asks for it."""
    with sweep(kind):
        lowered = jitted.lower(*args)
    has_kernel = "triton" in lowered.as_text()
    assert has_kernel == (kind == "triton"), (
        f"{kind} program {'holds' if has_kernel else 'lacks'} the kernel")
    return lowered.compile()


def envelope_case():
    import bench
    from hnanosolver_tpu.config import SolverParams
    from hnanosolver_tpu.models.plume import PlumeConfig

    topo = bench.envelope_topology()
    params = SolverParams(dt=1.0 / 24.0, voxel_size=0.5,
                          iterations=bench.ITERATIONS)
    cfg = PlumeConfig(center=(128.0, 24.0, 128.0), radius=20.0)
    return topo, params, cfg


def governors(capacity: int, n_scalars: int = 5) -> dict:
    """Which byte-cap governors engage for a domain of ``capacity`` tiles
    (the same conditions the ops test)."""
    from hnanosolver_tpu.ops import advection as adv
    from hnanosolver_tpu.ops import shifts as sh

    field = capacity * 512 * 4
    return {
        "NBRSUM_VIEWS_BUDGET": 6 * field > sh.NBRSUM_VIEWS_BUDGET,
        "MINMAX_VIEWS_BUDGET": 2 * n_scalars * field > sh.MINMAX_VIEWS_BUDGET,
        "CLAMP_VIEWS_BUDGET": 6 * n_scalars * field > adv.CLAMP_VIEWS_BUDGET,
        "ADVECT_TRANSIENT_BUDGET(scalars)":
            4 * field * n_scalars > adv.ADVECT_TRANSIENT_BUDGET,
        "ADVECT_TRANSIENT_BUDGET(velocity)":
            12 * field > adv.ADVECT_TRANSIENT_BUDGET,
        "sampling chunks": capacity // adv.chunk_size(capacity),
    }


def phase_envelope(ctx):
    import numpy as np

    import bench
    from hnanosolver_tpu.fields import zeros_state
    from hnanosolver_tpu.models.plume import plume_step_donated

    topo, params, cfg = envelope_case()
    state = zeros_state(topo)
    t0 = time.perf_counter()
    compiled = plume_step_donated.lower(topo, state, params, cfg).compile()
    aot_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(ma, k)}
    state, first_s, t, _ = bench.timed_window(
        lambda s: compiled(topo, s), state, steps=10, warmup=3)
    for name, f in [("velocity", state.velocity), *state.scalars.items()]:
        assert np.isfinite(np.asarray(f)).all(), f"non-finite {name}"
    dens = float(np.asarray(state.scalars["density"]).max())
    assert dens > 0, "the emitter added no density"
    peak = ctx["dev"].memory_stats().get("peak_bytes_in_use")
    ctx["envelope_state"] = state
    return (f"{int(topo.n_active)} tiles / {topo.num_voxels} voxels, "
            f"capacity {topo.capacity}; compile {aot_s:.2f} s (AOT), first "
            f"call {first_s:.2f} s; step {t * 1e3:.3f} ms over 10 steps "
            f"({topo.num_voxels / t / 1e6:.1f} M voxel-updates/s); "
            f"memory_analysis {mem}; peak_bytes_in_use {peak}; "
            f"max density {dens:.4f}; governors engaged "
            f"{governors(topo.capacity)}")


def phase_parity(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hnanosolver_tpu.config import SolverParams
    from hnanosolver_tpu.core import layout as L
    from hnanosolver_tpu.core.convert import dense_to_tiles, tiles_to_dense
    from hnanosolver_tpu.core.topology import build_topology_dense
    from hnanosolver_tpu.dense.solver import step_dense
    from hnanosolver_tpu.fields import FieldState
    from hnanosolver_tpu.solver import step

    n = PARITY_N
    rng = np.random.default_rng(0)
    x, y, z = np.meshgrid(*(np.arange(n, dtype=np.float32),) * 3,
                          indexing="ij")

    def smooth(a):
        for ax in range(3):
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
        return a

    noise = [smooth(rng.standard_normal((n,) * 3).astype(np.float32))
             for _ in range(2)]
    vel_d = jnp.asarray(np.stack([
        np.sin(2 * np.pi * y / n) + 0.3 * noise[0],
        np.cos(2 * np.pi * z / n) + 0.3 * noise[1],
        0.5 * np.sin(2 * np.pi * x / n),
    ], axis=-1).astype(np.float32))
    rho = jnp.asarray(np.exp(-((x - n / 2) ** 2 + (y - n / 2) ** 2
                               + (z - n / 2) ** 2) / (n / 4) ** 2))
    scalars_d = {"density": rho, "temperature": 30.0 * rho,
                 "fuel": 0.3 * rho, "waste": jnp.zeros_like(rho),
                 "flame": jnp.zeros_like(rho)}
    params = SolverParams(dt=0.2, iterations=50)

    topo = build_topology_dense((n, n, n))
    state = FieldState(
        velocity=L.vec_from_blocks(dense_to_tiles(topo, vel_d)),
        scalars={k: L.scalar_from_blocks(dense_to_tiles(topo, v))
                 for k, v in scalars_d.items()},
    )
    out = jax.block_until_ready(step(topo, state, params))
    want_v, want_s = jax.block_until_ready(step_dense(vel_d, scalars_d, params))
    got = {"velocity": tiles_to_dense(topo, L.vec_to_blocks(out.velocity),
                                      (n, n, n))}
    want = {"velocity": want_v}
    for k in scalars_d:
        got[k] = tiles_to_dense(topo, L.scalar_to_blocks(out.scalars[k]),
                                (n, n, n))
        want[k] = want_s[k]
    worst = {}
    for k in want:
        err = float(jnp.max(jnp.abs(got[k] - want[k])))
        scale = float(jnp.max(jnp.abs(want[k])))
        worst[k] = (err, scale)
        assert np.isfinite(err) and err <= PARITY_RTOL * max(scale, 1.0), (
            k, err, scale)
    return (f"{n}^3 dense ({topo.capacity} tiles), 50 iterations; worst "
            "abs error / field max per field: "
            + ", ".join(f"{k} {e:.3e}/{s:.3e}" for k, (e, s) in worst.items())
            + f"; tolerance {PARITY_RTOL} x max(1, field max)")


def phase_cook(ctx):
    import numpy as np

    from hnanosolver_tpu import cli
    from hnanosolver_tpu.io.vdb import read_vdb

    out = ctx["out"]
    plume_dir = os.path.join(out, "plume")
    fire_dir = os.path.join(out, "fire")
    t0 = time.perf_counter()
    cli.main(["plume", "--frames", "3", "--format", "vdb", "--ckpt-every",
              "1", "--out", plume_dir])
    t_plume = time.perf_counter() - t0
    leaves = []
    for f in range(1, 4):
        grids = read_vdb(os.path.join(plume_dir, f"frame_{f:04d}.vdb"))
        assert grids, f"frame {f}: no grids"
        for g in grids:
            assert np.isfinite(g["values"]).all(), (f, g["name"])
        leaves.append(len(grids[0]["origins"]))
    assert leaves[-1] > leaves[0], f"topology did not grow: {leaves}"
    t0 = time.perf_counter()
    cli.main(["fire", "--frames", "2", "--out", fire_dir])
    t_fire = time.perf_counter() - t0
    return (f"plume 3 frames -> .vdb in {t_plume:.1f} s, leaves per frame "
            f"{leaves}; fire 2 frames in {t_fire:.1f} s")


def phase_multigrid(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hnanosolver_tpu.models.plume import plume_step_donated
    from hnanosolver_tpu.ops import multigrid as mg
    from hnanosolver_tpu.ops import pressure as prs
    from hnanosolver_tpu.ops import stencil as stn

    topo, params, cfg = envelope_case()
    params = params.replace(pressure_solver="mg", iterations=8,
                            mg_levels=3, mg_tol=1e-3)
    hier = mg.hierarchy_for(topo, params)
    state = ctx["envelope_state"]
    div = stn.divergence(topo, state.velocity, params.inv_voxel_size)

    @jax.jit
    def ratios(div):
        scale = jnp.max(jnp.abs(div))
        p_mg = mg.solve_pressure_mg(
            topo, list(hier), div, params.iterations, params.voxel_size,
            params.omega, tol=params.mg_tol, n_pre=params.mg_pre,
            n_post=params.mg_post, n_coarsest=params.mg_coarsest,
            fmg=params.mg_fmg)
        p_gs = prs.solve_pressure(topo, div, 50, params.voxel_size,
                                  params.omega)
        r = [jnp.max(jnp.abs(prs.residual(topo, p, div, params.voxel_size)))
             for p in (p_mg, p_gs)]
        return scale, r[0] / scale, r[1] / scale

    scale, r_mg, r_gs = (float(v) for v in ratios(div))
    assert r_mg < 1.0 and np.isfinite(r_mg), r_mg
    t0 = time.perf_counter()
    out = jax.block_until_ready(plume_step_donated(
        topo, jax.tree.map(jnp.copy, state), params, cfg, hier))
    t = time.perf_counter() - t0
    assert np.isfinite(np.asarray(out.velocity)).all()
    return (f"mg_levels 3, mg_tol 1e-3, <= 8 V-cycles + FMG: max|r|/max|div| "
            f"{r_mg:.4e} (RBGS-50 on the same RHS: {r_gs:.4e}; max|div| "
            f"{scale:.4e}); one mg step incl. compile {t:.1f} s")


def phase_kernel(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hnanosolver_tpu.core.topology import active_mask
    from hnanosolver_tpu.ops import pressure as prs
    from hnanosolver_tpu.utils.timers import time_fn

    topo, params, _ = envelope_case()
    rng = np.random.default_rng(1)
    div = jnp.asarray(rng.standard_normal((topo.capacity, 512), np.float32)
                      ) * active_mask(topo)[:, None]
    dx, om = params.voxel_size, params.omega
    # the topology is an argument, as in the step: a closed-over one makes
    # its neighbour table a compile-time constant
    xla, tri = (compile_with(kind, jax.jit(lambda t, d: prs.solve_pressure(
        t, d, 50, dx, om)), topo, div) for kind in ("xla", "triton"))
    a, b = xla(topo, div), tri(topo, div)
    err = float(jnp.max(jnp.abs(a - b)))
    scale = float(jnp.max(jnp.abs(a)))
    assert err <= 1e-5 * max(scale, 1.0), (err, scale)
    t_x = [time_fn(xla, topo, div, iters=20)]
    t_t = [time_fn(tri, topo, div, iters=20)]
    t_t.append(time_fn(tri, topo, div, iters=20))
    t_x.append(time_fn(xla, topo, div, iters=20))
    return (f"50 iterations at {topo.capacity} tiles: max|triton - xla| "
            f"{err:.3e} (max|p| {scale:.3e}); median ms xla "
            f"{t_x[0] * 1e3:.3f}/{t_x[1] * 1e3:.3f}, triton "
            f"{t_t[0] * 1e3:.3f}/{t_t[1] * 1e3:.3f} (order xla, triton, "
            f"triton, xla)")


def phase_step_ab(ctx):
    """End-to-end step time with each sweep implementation, for the RBGS-50
    step and the multigrid step (the kernel runs its finest-level
    smoothers), compiled ahead of time, interleaved xla, triton, triton,
    xla. Every window starts from the same developed state."""
    import jax
    import jax.numpy as jnp

    import bench
    from hnanosolver_tpu.models.plume import emit
    from hnanosolver_tpu.ops import multigrid as mg
    from hnanosolver_tpu.solver import step_impl

    topo, rbgs, cfg = envelope_case()
    start = ctx["envelope_state"]
    order = ("xla", "triton", "triton", "xla")
    out = []
    for name, params in (("rbgs-50", rbgs), ("mg", rbgs.replace(
            pressure_solver="mg", iterations=8, mg_levels=3, mg_tol=1e-3))):
        hier = mg.hierarchy_for(topo, params)
        steps = {kind: compile_with(kind, jax.jit(
            lambda t, s, h, p=params: step_impl(
                t, emit(t, s, cfg, p.dt), p, h),
            donate_argnums=(1,)), topo, start, hier)
            for kind in ("xla", "triton")}
        ms = {"xla": [], "triton": []}
        for kind in order:
            _, _, t, _ = bench.timed_window(
                lambda s, f=steps[kind]: f(topo, s, hier),
                jax.tree.map(jnp.copy, start), steps=10, warmup=3)
            ms[kind].append(t * 1e3)
        out.append(f"{name}: xla {ms['xla']}, triton {ms['triton']}")
    return (f"step ms at the envelope (order {', '.join(order)}; 10 steps "
            f"per window after 3 warm-up steps): " + "; ".join(out))


def phase_gpu_tests(ctx):
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    assert rc == 0, f"pytest exit code {rc}"
    return "tests marked gpu passed"


def phase_four_cards(ctx):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from hnanosolver_tpu.core.topology import active_mask
    from hnanosolver_tpu.fields import zeros_state
    from hnanosolver_tpu.models.plume import plume_step
    from hnanosolver_tpu.parallel.slab import (
        build_slabs,
        gather_state,
        scatter_state,
        sharded_plume_step,
    )

    devs = jax.devices()
    assert len(devs) >= 4, f"needs 4 GPUs, found {len(devs)}"
    topo, params, cfg = envelope_case()
    state = zeros_state(topo)
    for _ in range(2):  # develop non-trivial fields first
        state = plume_step(topo, state, params, cfg)
    want = jax.block_until_ready(plume_step(topo, state, params, cfg))

    mesh = Mesh(np.asarray(devs[:4]), ("x",))
    slab = build_slabs(topo, 4)
    stacked = scatter_state(topo, slab, state)
    fn = sharded_plume_step(mesh, slab, params, cfg)
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(slab, stacked))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(5):
        out2 = fn(slab, stacked)
    jax.block_until_ready(out2)
    t = (time.perf_counter() - t0) / 5
    got = gather_state(topo, slab, out)
    mb = np.asarray(active_mask(topo)).astype(bool)
    worst = {}
    pairs = [("velocity", got.velocity, want.velocity)] + [
        (k, got.scalars[k], want.scalars[k]) for k in want.scalars]
    for k, g, w in pairs:
        g = np.asarray(g)[..., mb, :]
        w = np.asarray(w)[..., mb, :]
        np.testing.assert_allclose(g, w, rtol=SHARDED_RTOL, atol=1e-5,
                                   err_msg=k)
        worst[k] = float(np.max(np.abs(g - w)))
    return (f"slab-sharded plume step on 4 GPUs vs single-device step at "
            f"{topo.num_voxels} voxels: worst abs diff {worst} (rtol "
            f"{SHARDED_RTOL}); first call {first:.1f} s, then "
            f"{t * 1e3:.3f} ms/step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded-step phase")
    ap.add_argument("--out", default=os.path.join(ROOT, ".smoke_out"),
                    help="directory for the cook phase's frames")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"phase device: FAILED: JAX's default device is {dev.platform}, "
            "not a GPU")
        return 1
    log(f"phase device: ok ({dev.device_kind}, {len(jax.devices())} "
        f"device(s), jax {jax.__version__})")
    ctx = {"dev": dev, "out": args.out}
    if args.four_cards:
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("envelope", phase_envelope), ("parity", phase_parity),
                  ("cook", phase_cook), ("multigrid", phase_multigrid),
                  ("kernel", phase_kernel), ("step-ab", phase_step_ab),
                  ("gpu-tests", phase_gpu_tests)]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            msg = fn(ctx)
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) {msg}")
        except Exception as e:  # noqa: BLE001 — report every phase
            ok = False
            traceback.print_exc()
            log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s): "
                f"{type(e).__name__}: {e}")
            if name == "envelope":
                break  # later phases reuse its state
    if not ok:
        return 1
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-phase step profiling — the ScopedTimerGPU table of the reference.

The reference times every kernel per cook with cudaEvents and a bytes/voxel
bandwidth model (`/root/reference/src/Cuda/Utils.cuh:246-277`, call sites
`/root/reference/src/Cuda/HNanoSolver.cu:163-343`). Here each phase is one
jitted function, compiled and warmed outside the timed window, and timed as
the median host-clock wall time of calls that end in ``block_until_ready``
(utils/timers.time_fn). Per-kernel device time belongs to a profiler trace;
this table is the quick host-side view.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp

from hnanosolver_tpu.utils.timers import time_fn


def phase_functions(topo, state, params) -> List[Tuple[str, Callable, object]]:
    """(name, body, x0) per pipeline phase; ``body(x0)`` runs the phase
    once with its real work shape."""
    from hnanosolver_tpu.ops import advection as adv
    from hnanosolver_tpu.ops import combustion as comb
    from hnanosolver_tpu.ops import pressure as prs
    from hnanosolver_tpu.ops import stencil as stn

    inv_dx = params.inv_voxel_size
    dt = params.dt
    c = params.combustion
    vel = state.velocity
    scal = {k: v for k, v in state.scalars.items() if k != "collision_sdf"}
    div0 = stn.divergence(topo, vel, inv_dx)

    phases: List[Tuple[str, Callable, object]] = []

    phases.append((
        "advect_velocity (BFECC)",
        lambda v: adv.advect_velocity(topo, v, dt, inv_dx, None),
        vel,
    ))
    phases.append((
        "vorticity_confinement",
        lambda v: stn.vorticity_confinement(
            topo, v, dt, inv_dx, max(c.vorticity_scale, 0.1), c.factor_scale
        ),
        vel,
    ))
    phases.append((
        "divergence",
        lambda v: stn.divergence(topo, v, inv_dx),
        vel,
    ))
    phases.append((
        "combustion+buoyancy",
        lambda args: (lambda f, w, t, fl, d: (
            f, w,
            comb.temperature_buoyancy(
                jnp.stack([t, t, t]), t, dt, c.ambient_temp, c.buoyancy_strength
            )[1],
            fl, d,
        ))(*comb.combustion_oxygen(
            args[0], args[1], args[2], args[3], args[4],
            c.temperature_release, c.expansion_rate,
        )),
        (scal["fuel"], scal["waste"], scal["temperature"], scal["flame"], div0),
    ))
    phases.append((
        f"pressure ({params.iterations} RBGS iters)",
        lambda d: prs.solve_pressure(
            topo, d, params.iterations, params.voxel_size, params.omega
        ),
        div0,
    ))
    phases.append((
        "subtract_pressure_gradient",
        lambda v: stn.subtract_pressure_gradient(topo, v, div0, inv_dx),
        vel,
    ))

    names = sorted(scal)
    stacked = jnp.stack([scal[k] for k in names])

    def adv_scal(s):
        outs = adv.advect_scalars_fused(
            topo, vel, {k: s[i] for i, k in enumerate(names)}, dt, inv_dx
        )
        return jnp.stack([outs[k] for k in names])

    phases.append((f"advect_scalars ({len(names)} fields, fused)", adv_scal, stacked))
    return phases


def profile(topo, state, params, iters: int = 10) -> Dict[str, float]:
    """{phase name: median seconds per call} for each pipeline phase, plus
    'FULL STEP'."""
    from hnanosolver_tpu.solver import step

    out: Dict[str, float] = {}
    for name, fn, x0 in phase_functions(topo, state, params):
        out[name] = time_fn(jax.jit(fn), x0, iters=iters)
    out["FULL STEP"] = time_fn(
        jax.jit(lambda s: step(topo, s, params)), state, iters=iters
    )
    return out


def markdown_table(times: Dict[str, float], voxels: int) -> str:
    total = times.get("FULL STEP", sum(times.values()))
    lines = [
        "| phase | ms | % of step | Mvox/s |",
        "|---|---|---|---|",
    ]
    for name, t in times.items():
        lines.append(
            f"| {name} | {t * 1e3:.2f} | {100 * t / total:.1f}% "
            f"| {voxels / t / 1e6:.1f} |"
        )
    return "\n".join(lines)

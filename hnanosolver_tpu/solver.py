"""The full simulation step and the four standalone operator entry points.

``step`` reproduces the reference pipeline contract — the exact kernel order
of ``Compute`` (`/root/reference/src/Cuda/HNanoSolver.cu:150-356`):

  1. enforce collision boundaries on u            (if SDF)
  2. u* = BFECC self-advection of u
  3. u* += vorticity confinement force
  4. div = divergence(u*)
  5. combustion: burn fuel, heat, div += burn*expansion
  6. u* += buoyancy from post-combustion temperature
  7. p = red-black SOR, 2 x iterations sweeps, omega = 2/(1+sin(pi dx))
  8. u = u* - grad(p)                              (+ collision no-slip)
  9. enforce collision boundaries on u            (if SDF)
 10. scalars advected by the projected u (post-combustion values for the
     combustion fields), skipping collision_sdf

Unlike the reference — which pays H2D + D2H copies and a full NanoVDB grid
rebuild every cook — the whole step is one jit-compiled function over
device-resident arrays; frames chain on-device (``jax.lax.scan``-able).

Documented deviations (SURVEY §7.5): background reads are exact zeros, and
``collision_sdf`` is NOT destroyed after a collision step (the reference
zeroes it via its copy-back loop, HNanoSolver.cu:364-369 — a bug).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from hnanosolver_tpu.config import SolverParams
from hnanosolver_tpu.core.topology import Topology
from hnanosolver_tpu.fields import (
    COLLISION_FIELD,
    COMBUSTION_FIELDS,
    FieldState,
    mask_state,
)
from hnanosolver_tpu.ops import advection as adv
from hnanosolver_tpu.ops import collision as col
from hnanosolver_tpu.ops import combustion as comb
from hnanosolver_tpu.ops import pressure as prs
from hnanosolver_tpu.ops import stencil as stn


def _require_combustion_fields(state: FieldState):
    missing = [f for f in COMBUSTION_FIELDS if f not in state.scalars]
    if missing:
        # Same contract as the reference (HNanoSolver.cu:193-201).
        raise ValueError(f"missing required combustion fields: {missing}")


def _identity(f):
    return f


def step_impl(
    topo: Topology,
    state: FieldState,
    params: SolverParams,
    hierarchy: tuple = (),
    refresh=_identity,
    coarse_reduce=None,
    tol_reduce=None,
) -> FieldState:
    """THE pipeline — the single implementation behind both the one-chip
    ``step`` and the shard_map slab step (parallel/slab.py).

    ``refresh`` is the halo-exchange hook: identity on one chip, a ppermute
    ghost-row push under shard_map. It is applied to every array right
    before an op that reads cross-tile neighbors, so the sharded step runs
    literally this code. The caller must hand in ghost-fresh ``state``.

    ``hierarchy``: coarse levels from ``ops.multigrid.build_hierarchy`` when
    ``params.pressure_solver == "mg"`` (tuple so it stays a pytree)."""
    _require_combustion_fields(state)
    c = params.combustion
    inv_dx = params.inv_voxel_size
    dt = params.dt

    sdf = state.sdf() if params.has_collision else None
    vel = state.velocity
    if sdf is not None:
        vel = refresh(col.enforce_collision(topo, vel, sdf, inv_dx))

    # 1-2. velocity self-advection + vorticity confinement
    u_star = adv.advect_velocity(topo, vel, dt, inv_dx, sdf)
    u_star = refresh(u_star)
    u_star = stn.vorticity_confinement(
        topo, u_star, dt, inv_dx, c.vorticity_scale, c.factor_scale
    )
    u_star = refresh(u_star)

    # 3. divergence of the intermediate velocity
    div = stn.divergence(topo, u_star, inv_dx)

    # 4. combustion (adds expansion into div) ...
    fuel, waste, temp, flame, div = comb.combustion_oxygen(
        state.scalars["fuel"],
        state.scalars["waste"],
        state.scalars["temperature"],
        state.scalars["flame"],
        div,
        c.temperature_release,
        c.expansion_rate,
    )
    # ... then buoyancy from the POST-combustion temperature
    # (HNanoSolver.cu:228-232).
    u_star = comb.temperature_buoyancy(
        u_star, temp, dt, c.ambient_temp, c.buoyancy_strength
    )

    # 5. pressure solve + projection
    div = refresh(div)
    # None (not the identity closure) tells the solvers no exchange is
    # needed, so the single-device pressure kernel can run
    rf_solver = None if refresh is _identity else refresh
    if params.pressure_solver == "mg" and hierarchy:
        from hnanosolver_tpu.ops.multigrid import solve_pressure_mg

        p = solve_pressure_mg(
            topo, list(hierarchy), div, params.iterations, params.voxel_size,
            params.omega, tol=params.mg_tol, n_pre=params.mg_pre,
            n_post=params.mg_post, n_coarsest=params.mg_coarsest,
            refresh=rf_solver, coarse_reduce=coarse_reduce,
            fmg=params.mg_fmg, tol_reduce=tol_reduce,
        )
    else:
        p = prs.solve_pressure(
            topo, div, params.iterations, params.voxel_size, params.omega,
            refresh=rf_solver,
        )
    p = refresh(p)
    u_star = refresh(u_star)
    vel_out = stn.subtract_pressure_gradient(topo, u_star, p, inv_dx)
    if sdf is not None:
        # subtractPressureGradient's collision tail (Kernel.cu:808-826)
        vel_out = col.enforce_collision(topo, vel_out, sdf, inv_dx)
        # second enforceCollisionBoundaries launch (HNanoSolver.cu:292-296)
        vel_out = col.enforce_collision(topo, vel_out, sdf, inv_dx)
    vel_out = refresh(vel_out)

    # 6. advect all scalars (post-combustion state) by the projected velocity
    to_advect = dict(state.scalars)
    to_advect.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
    sdf_in = to_advect.pop(COLLISION_FIELD, None)
    to_advect = {k: refresh(v) for k, v in to_advect.items()}
    advected = adv.advect_scalars_fused(
        topo, vel_out, to_advect, dt, inv_dx, sdf
    )
    if sdf_in is not None:
        advected[COLLISION_FIELD] = sdf_in  # preserved, not zeroed (see above)

    return mask_state(topo, FieldState(velocity=vel_out, scalars=advected))


@partial(jax.jit, static_argnames=("params",))
def step(
    topo: Topology,
    state: FieldState,
    params: SolverParams,
    hierarchy: tuple = (),
) -> FieldState:
    """One full simulation step on one device. Pure function: state in,
    state out. See ``step_impl`` for the pipeline."""
    return step_impl(topo, state, params, hierarchy)


# frame-loop variant: DONATES the input state's buffers (the old state is
# dead once the new one exists), halving resident field memory — at
# 1024^3-class domains this is the difference between fitting and OOM.
# Do not touch the passed state after calling (models.run_* use this).
step_donated = partial(
    jax.jit, static_argnames=("params",), donate_argnums=(1,)
)(step_impl)


# ---------------------------------------------------------------------------
# Standalone operator entry points — the other four SOP nodes.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("dt", "voxel_size"))
def advect_scalars(
    topo: Topology,
    vel: jax.Array,
    scalars,
    dt: float,
    voxel_size: float,
):
    """HNanoAdvect: BFECC-advect every float field by ``vel``
    (`/root/reference/src/Cuda/Advection.cu:13-111`)."""
    return adv.advect_scalars_fused(topo, vel, dict(scalars), dt, 1.0 / voxel_size)


@partial(jax.jit, static_argnames=("dt", "voxel_size"))
def advect_velocity(topo: Topology, vel: jax.Array, dt: float, voxel_size: float):
    """HNanoAdvectVelocity: BFECC self-advection
    (`/root/reference/src/Cuda/Advection.cu:114-167`)."""
    return adv.advect_velocity(topo, vel, dt, 1.0 / voxel_size)


@partial(jax.jit, static_argnames=("iterations", "voxel_size"))
def project(
    topo: Topology, vel: jax.Array, iterations: int, voxel_size: float
) -> jax.Array:
    """HNanoProjectNonDivergent: divergence -> RBGS -> gradient subtraction
    (`/root/reference/src/Cuda/PressureProjection.cu:9-79`)."""
    inv_dx = 1.0 / voxel_size
    div = stn.divergence(topo, vel, inv_dx)
    import math

    omega = 2.0 / (1.0 + math.sin(3.14159 * voxel_size))
    p = prs.solve_pressure(topo, div, iterations, voxel_size, omega)
    return stn.subtract_pressure_gradient(topo, vel, p, inv_dx)


@partial(jax.jit, static_argnames=("voxel_size",))
def divergence_only(topo: Topology, vel: jax.Array, voxel_size: float) -> jax.Array:
    """HNanoProjectNonDivergent with "output divergence" toggled
    (`/root/reference/src/Cuda/PressureProjection.cu:81-125`)."""
    return stn.divergence(topo, vel, 1.0 / voxel_size)

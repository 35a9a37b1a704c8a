"""Collocated central-difference stencil ops: divergence, pressure-gradient
subtraction, vorticity confinement — flat layout ([T,512] scalars,
[3,T,512] velocity).

Semantics match the reference's device kernels exactly (collocated central
differences, NOT true MAC staggering — a documented reference quirk,
SURVEY §7.5):

- divergence:              `/root/reference/src/Cuda/Kernel.cu:499-519`
- subtractPressureGradient:`/root/reference/src/Cuda/Kernel.cu:765-829`
- vorticityConfinement:    `/root/reference/src/Cuda/Kernel.cu:970-1025`
  (+ computeVorticityMag,  `/root/reference/src/Cuda/Utils.cuh:226-243`)

All neighbor access goes through ops/shifts.py (in-tile rolls + row gathers);
out-of-domain reads are exact background 0 via the null tile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hnanosolver_tpu.core.topology import Topology
from hnanosolver_tpu.ops.shifts import offset_view, shifted_view, shifted_views


_AXIS_OFFS = (((1, 0, 0), (-1, 0, 0)), ((0, 1, 0), (0, -1, 0)),
              ((0, 0, 1), (0, 0, -1)))


def divergence(topo: Topology, vel: jax.Array, inv_dx: float) -> jax.Array:
    """div(u) at cell centers: the reference averages face values
    0.5*(u_c + u_nbr) on both sides and differences them (`Kernel.cu:511-518`),
    which reduces to (u_{+1} - u_{-1}) / (2 dx) per axis. vel [3,T,512].

    At-scale domains chain the per-axis terms through optimization_barrier
    (bit-identical; same left-associated order) so XLA cannot schedule all
    six view gathers concurrently — see shifts.neighbor_sum."""
    from hnanosolver_tpu.ops.shifts import NBRSUM_VIEWS_BUDGET

    if 2 * vel.size * 4 > NBRSUM_VIEWS_BUDGET:
        acc = None
        src = vel
        for c, (op, om) in enumerate(_AXIS_OFFS):
            term = shifted_view(topo, src[c], op) - shifted_view(topo, src[c], om)
            acc = term if acc is None else acc + term
            acc, src = jax.lax.optimization_barrier((acc, src))
        return acc * (0.5 * inv_dx)
    ux, uy, uz = vel[0], vel[1], vel[2]
    return (
        (shifted_view(topo, ux, (1, 0, 0)) - shifted_view(topo, ux, (-1, 0, 0)))
        + (shifted_view(topo, uy, (0, 1, 0)) - shifted_view(topo, uy, (0, -1, 0)))
        + (shifted_view(topo, uz, (0, 0, 1)) - shifted_view(topo, uz, (0, 0, -1)))
    ) * (0.5 * inv_dx)


def pressure_gradient(topo: Topology, p: jax.Array, inv_dx: float) -> jax.Array:
    """grad(p) at cell centers, [3,T,512]."""
    v = shifted_views(topo, p)
    return jnp.stack(
        [
            v[(1, 0, 0)] - v[(-1, 0, 0)],
            v[(0, 1, 0)] - v[(0, -1, 0)],
            v[(0, 0, 1)] - v[(0, 0, -1)],
        ]
    ) * (0.5 * inv_dx)


def subtract_pressure_gradient(
    topo: Topology, vel: jax.Array, p: jax.Array, inv_dx: float
) -> jax.Array:
    """u <- u* - grad(p). dt/rho is absorbed into p's units, as in the
    reference (`Kernel.cu:804-806`). Collision no-slip blending is applied
    separately (ops/collision.py), matching the kernel's tail.

    At-scale domains compute one axis at a time behind optimization_barrier
    (bit-identical) instead of materializing all six p-views at once."""
    from hnanosolver_tpu.ops.shifts import NBRSUM_VIEWS_BUDGET

    if 2 * vel.size * 4 > NBRSUM_VIEWS_BUDGET:
        comps = []
        src = p
        for c, (op, om) in enumerate(_AXIS_OFFS):
            g = (shifted_view(topo, src, op) - shifted_view(topo, src, om)) * (
                0.5 * inv_dx
            )
            comp = vel[c] - g
            comp, src = jax.lax.optimization_barrier((comp, src))
            comps.append(comp)
        return jnp.stack(comps)
    return vel - pressure_gradient(topo, p, inv_dx)


def curl(topo: Topology, vel: jax.Array, factor: float) -> jax.Array:
    """omega = curl(u) via central differences; factor = 0.5/dx. [3,T,512]."""
    ux, uy, uz = vel[0], vel[1], vel[2]

    def dvd(f, off_p, off_m):
        return shifted_view(topo, f, off_p) - shifted_view(topo, f, off_m)

    wx = (dvd(uz, (0, 1, 0), (0, -1, 0)) - dvd(uy, (0, 0, 1), (0, 0, -1))) * factor
    wy = (dvd(ux, (0, 0, 1), (0, 0, -1)) - dvd(uz, (1, 0, 0), (-1, 0, 0))) * factor
    wz = (dvd(uy, (1, 0, 0), (-1, 0, 0)) - dvd(ux, (0, 1, 0), (0, -1, 0))) * factor
    return jnp.stack([wx, wy, wz])


def _curl_mag_at_offset(topo: Topology, vel: jax.Array, off, factor: float,
                        tables=None):
    """|curl u| evaluated at voxel+off — matches the reference's pointwise
    recomputation through the tree sampler (Utils.cuh:226-243), which can be
    nonzero just outside the active set. ``tables``: pre-materialized
    27-neighborhood tables per velocity component (the six offset
    evaluations share them; without sharing each of the 72 reads would
    re-gather a full [T, 27*512] table — 24x the needed HBM traffic)."""
    from hnanosolver_tpu.core.layout import CX, CY, CZ
    from hnanosolver_tpu.ops import shifts as sh

    def v(c, o):
        ox, oy, oz = off[0] + o[0], off[1] + o[1], off[2] + o[2]
        if tables is None:
            return offset_view(topo, vel[c], (ox, oy, oz))
        idx = sh.table_index(CX + ox, CY + oy, CZ + oz)
        return sh.gather_table(
            tables[c], jnp.broadcast_to(idx, vel[c].shape)
        )

    wx = ((v(2, (0, 1, 0)) - v(2, (0, -1, 0))) - (v(1, (0, 0, 1)) - v(1, (0, 0, -1)))) * factor
    wy = ((v(0, (0, 0, 1)) - v(0, (0, 0, -1))) - (v(2, (1, 0, 0)) - v(2, (-1, 0, 0)))) * factor
    wz = ((v(1, (1, 0, 0)) - v(1, (-1, 0, 0))) - (v(0, (0, 1, 0)) - v(0, (0, -1, 0)))) * factor
    return jnp.sqrt(wx * wx + wy * wy + wz * wz)


def vorticity_confinement(
    topo: Topology,
    vel: jax.Array,
    dt: float,
    inv_dx: float,
    confinement_scale: float,
    factor_scale: float,
) -> jax.Array:
    """u += scale * (N x omega) * dt with N = normalize(grad |omega|).

    The gradient of |omega| is sampled at integer offset ``s = int(factor_scale)``
    per axis — the reference constructs ``nanovdb::Coord(factorScale,0,0)``,
    truncating the float param to int (`Kernel.cu:998-1007`); with the SOP
    default 0.5 the offset truncates to 0 and the force vanishes. We keep
    that truncation for parity."""
    s = int(factor_scale)
    if s == 0:
        # Offset 0 makes every grad component an exact 0, so N = 0/(0+1e-5)
        # = 0 and force = N x omega = 0: the reference's kernel produces
        # u += 0 here (it still pays the launch; we don't have to). The SOP
        # default factor_scale 0.5 lands on this path.
        return vel
    factor = 0.5 * inv_dx
    omega = curl(topo, vel, factor)

    from hnanosolver_tpu.ops.shifts import neighbor_table

    tables = [neighbor_table(topo, vel[c]) for c in range(3)]
    gx = (
        _curl_mag_at_offset(topo, vel, (s, 0, 0), factor, tables)
        - _curl_mag_at_offset(topo, vel, (-s, 0, 0), factor, tables)
    ) * factor
    gy = (
        _curl_mag_at_offset(topo, vel, (0, s, 0), factor, tables)
        - _curl_mag_at_offset(topo, vel, (0, -s, 0), factor, tables)
    ) * factor
    gz = (
        _curl_mag_at_offset(topo, vel, (0, 0, s), factor, tables)
        - _curl_mag_at_offset(topo, vel, (0, 0, -s), factor, tables)
    ) * factor
    grad = jnp.stack([gx, gy, gz])

    # normalize with the reference's +1e-5 regularizer (Kernel.cu:1015)
    glen = jnp.sqrt(jnp.sum(grad * grad, axis=0, keepdims=True)) + 1e-5
    N = grad / glen
    # force = N x omega, channel-major cross product
    force = jnp.stack(
        [
            N[1] * omega[2] - N[2] * omega[1],
            N[2] * omega[0] - N[0] * omega[2],
            N[0] * omega[1] - N[1] * omega[0],
        ]
    )
    return vel + confinement_scale * force * dt

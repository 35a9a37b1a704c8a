"""MacCormack/BFECC advection of scalar and vector fields — flat layout.

Reference kernels:
- advect_scalars (fused multi-field): `/root/reference/src/Cuda/Kernel.cu:118-266`
- advect_scalar  (single field):      `/root/reference/src/Cuda/Kernel.cu:269-352`
- advect_vector  (velocity self-adv): `/root/reference/src/Cuda/Kernel.cu:354-453`

Scheme per voxel at position x (index space, scaled_dt = dt / dx):
  1. backPos  = x - u(x) * scaled_dt               (semi-Lagrangian backtrace)
  2. phiF     = phi(backPos)                        (trilinear)
  3. fwdPos2  = backPos + u(backPos) * scaled_dt    (forward re-trace)
  4. phiB     = phi(fwdPos2)
  5. phiCorr  = phiF + 0.5 * (phi(x) - phiB)        (BFECC correction)
  6. clamp phiCorr to [min, max] over {phi(x), 6-neighbors of x, phiF}
With an SDF: trace positions landing inside the solid are rejected back to
the previous position; advect_vector additionally applies its no-slip tail.

Mapping onto the flat layout ([T,512] fields, [3,T,512] velocity):
- Trace displacements are relative to each voxel and CFL-clamped to < 7
  voxels, so every trilinear corner lies inside the tile's 3x3x3
  neighborhood. Each field's neighborhood is ONE contiguous row gather
  (``[C, 27*512]``) and each corner read is ONE batched in-row gather —
  the reference's 8-corner read, addressed through ``topo.nbr`` instead of
  a tree probe. No binary searches, no padded halo buffers.
- Corner indices and weights are computed once per trace position set and
  shared across all fields (the fused-kernel optimization).
- The tile axis runs in ``lax.map`` chunks to bound the neighborhood-table
  temporaries (~57 MB per field at the default chunk).
- Displacement clamping is a documented deviation: the reference traces
  arbitrarily far (`Kernel.cu:139`); plumes at sane dt stay well under.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from hnanosolver_tpu.core.layout import CX, CY, CZ, TILE
from hnanosolver_tpu.core.topology import Topology
from hnanosolver_tpu.ops import shifts as sh

# Tiles per lax.map chunk of the sampling pass: bounds the [chunk, 27*512]
# neighborhood tables to ~57 MB per field. A memory cap, not a tuned speed
# setting; domains at or below one chunk run in a single map step.
DEFAULT_CHUNK = 1024
DISP_LIMIT = 7.0 - 1e-3  # max |displacement| per axis per trace (voxels)


def _clamp(d):
    return jnp.clip(d, -DISP_LIMIT, DISP_LIMIT)


def cfl_clamped_count(topo: Topology, vel: jax.Array, dt: float,
                      inv_dx: float) -> jax.Array:
    """Number of active voxels where a trace clamp CAN engage, diverging
    from the reference's unbounded trace (`Kernel.cu:139`).

    Covers BOTH clamps: the backtrace clamps at
    |u|*dt/dx > DISP_LIMIT, and the BFECC forward re-trace clamps
    d2 = d + u(back)*sdt, which |d2| <= 2*|d| bounds — so the conservative
    trigger is 2*|u|*dt/dx > DISP_LIMIT. Counts voxels that MAY deviate
    (an upper bound; the re-trace clamp depends on the sampled velocity).
    Jit-safe scalar; zero for flows with |u| * dt / dx < 3.5."""
    from hnanosolver_tpu.core.topology import active_mask

    d = jnp.abs(vel) * (dt * inv_dx)
    hit = jnp.any(2.0 * d > DISP_LIMIT, axis=0) * active_mask(topo)[:, None]
    return jnp.sum(hit).astype(jnp.int32)


def _corners(dx, dy, dz):
    """Displacements [C,512] -> (8 corner index arrays into the 27-table,
    8 weight arrays). Corner coords stay within [-8, 15] by the CFL clamp."""
    lx = CX.astype(jnp.float32) + dx
    ly = CY.astype(jnp.float32) + dy
    lz = CZ.astype(jnp.float32) + dz
    bx = jnp.floor(lx)
    by = jnp.floor(ly)
    bz = jnp.floor(lz)
    fx, fy, fz = lx - bx, ly - by, lz - bz
    bx, by, bz = bx.astype(jnp.int32), by.astype(jnp.int32), bz.astype(jnp.int32)
    ix, iy, iz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    out = []
    for di in (0, 1):
        wx = fx if di else ix
        for dj in (0, 1):
            wy = fy if dj else iy
            for dk in (0, 1):
                wz = fz if dk else iz
                idx = sh.table_index(bx + di, by + dj, bz + dk)
                out.append((idx, wx * wy * wz))
    return out


def _sample(table, corners):
    """Trilinear read from one field's 27-table at precomputed corners."""
    acc = None
    for idx, w in corners:
        v = sh.gather_table(table, idx) * w
        acc = v if acc is None else acc + v
    return acc


def chunk_size(capacity: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Tiles per sampling chunk: the largest divisor of ``capacity`` that is
    at most ``chunk`` (capacities are multiples of 512 above 2048 tiles, so
    this stays near ``chunk``; e.g. 768 at capacity 4608)."""
    c = min(chunk, capacity)
    while capacity % c:
        c -= 1
    return c


def _advect_chunked(
    topo: Topology,
    vel: jax.Array,
    fields: Sequence[jax.Array],
    scaled_dt: float,
    sdf: Optional[jax.Array],
    chunk: int,
    trace_order: int = 1,
    fields_are_velocity: bool = False,
):
    """Core BFECC: returns (phiF, phiB) stacked [len(fields), T, 512].
    Shares trace positions and interpolation weights across all fields.
    ``fields_are_velocity``: the advected fields ARE the velocity components
    (self-advection), so the back-position pass samples them once, not twice."""

    def table(full_field, nbr27):
        C = nbr27.shape[0]
        return jnp.take(full_field, nbr27.reshape(-1), axis=0).reshape(
            C, 27 * TILE
        )

    def body(args):
        nbr27, vx, vy, vz = args

        def sample_many(tables, dx, dy, dz):
            cs = _corners(dx, dy, dz)
            return [_sample(t, cs) for t in tables]

        if trace_order >= 2:
            # RK backtrace (the reference ships rk3/rk4 integrators in
            # /root/reference/src/Cuda/Utils.cuh even though its pipeline
            # uses the 1st-order trace; trace_order=1 matches the pipeline).
            vxt0 = table(vel[0], nbr27)
            vyt0 = table(vel[1], nbr27)
            vzt0 = table(vel[2], nbr27)

            def vel_at(dx, dy, dz):
                return tuple(sample_many([vxt0, vyt0, vzt0], dx, dy, dz))

            if trace_order == 2:  # midpoint
                mx, my, mz = vel_at(
                    _clamp(-0.5 * vx * scaled_dt),
                    _clamp(-0.5 * vy * scaled_dt),
                    _clamp(-0.5 * vz * scaled_dt),
                )
                dx = _clamp(-mx * scaled_dt)
                dy = _clamp(-my * scaled_dt)
                dz = _clamp(-mz * scaled_dt)
            elif trace_order == 3:  # RK3 (Ralston)
                k1x, k1y, k1z = vx, vy, vz
                k2x, k2y, k2z = vel_at(
                    _clamp(-0.5 * k1x * scaled_dt),
                    _clamp(-0.5 * k1y * scaled_dt),
                    _clamp(-0.5 * k1z * scaled_dt),
                )
                k3x, k3y, k3z = vel_at(
                    _clamp(-0.75 * k2x * scaled_dt),
                    _clamp(-0.75 * k2y * scaled_dt),
                    _clamp(-0.75 * k2z * scaled_dt),
                )
                dx = _clamp(-(2 * k1x + 3 * k2x + 4 * k3x) / 9.0 * scaled_dt)
                dy = _clamp(-(2 * k1y + 3 * k2y + 4 * k3y) / 9.0 * scaled_dt)
                dz = _clamp(-(2 * k1z + 3 * k2z + 4 * k3z) / 9.0 * scaled_dt)
            else:  # classic RK4 (reference rk4_integrate, Utils.cuh)
                k1x, k1y, k1z = vx, vy, vz
                k2x, k2y, k2z = vel_at(
                    _clamp(-0.5 * k1x * scaled_dt),
                    _clamp(-0.5 * k1y * scaled_dt),
                    _clamp(-0.5 * k1z * scaled_dt),
                )
                k3x, k3y, k3z = vel_at(
                    _clamp(-0.5 * k2x * scaled_dt),
                    _clamp(-0.5 * k2y * scaled_dt),
                    _clamp(-0.5 * k2z * scaled_dt),
                )
                k4x, k4y, k4z = vel_at(
                    _clamp(-k3x * scaled_dt),
                    _clamp(-k3y * scaled_dt),
                    _clamp(-k3z * scaled_dt),
                )
                dx = _clamp(-(k1x + 2 * k2x + 2 * k3x + k4x) / 6.0 * scaled_dt)
                dy = _clamp(-(k1y + 2 * k2y + 2 * k3y + k4y) / 6.0 * scaled_dt)
                dz = _clamp(-(k1z + 2 * k2z + 2 * k3z + k4z) / 6.0 * scaled_dt)
        else:
            dx = _clamp(-vx * scaled_dt)
            dy = _clamp(-vy * scaled_dt)
            dz = _clamp(-vz * scaled_dt)
        if sdf is not None:
            sdf_t = table(sdf, nbr27)
            d = sample_many([sdf_t], dx, dy, dz)[0]
            hit = d < 0.0  # backtrace entered the solid -> stay (Kernel.cu:141-155)
            dx = jnp.where(hit, 0.0, dx)
            dy = jnp.where(hit, 0.0, dy)
            dz = jnp.where(hit, 0.0, dz)
        def sample_many_fields(fs, dx, dy, dz):
            return sample_many([table(f, nbr27) for f in fs], dx, dy, dz)

        # one pass at the back position samples velocity AND all fields
        # (shared interpolation weights — the fused-kernel trick); for
        # self-advection the fields ARE the velocity, so sample them once
        if fields_are_velocity:
            back_samples = sample_many_fields(list(fields), dx, dy, dz)
            vfx, vfy, vfz = back_samples[:3]
            phis_f = back_samples
        else:
            back_samples = sample_many_fields(
                [vel[0], vel[1], vel[2]] + list(fields), dx, dy, dz
            )
            vfx, vfy, vfz = back_samples[:3]
            phis_f = back_samples[3:]
        d2x = _clamp(dx + vfx * scaled_dt)
        d2y = _clamp(dy + vfy * scaled_dt)
        d2z = _clamp(dz + vfz * scaled_dt)
        if sdf is not None:
            d2 = sample_many([sdf_t], d2x, d2y, d2z)[0]
            hit2 = d2 < 0.0  # retrace entered the solid -> stay at backPos
            d2x = jnp.where(hit2, dx, d2x)
            d2y = jnp.where(hit2, dy, d2y)
            d2z = jnp.where(hit2, dz, d2z)
        phis_b = sample_many_fields(list(fields), d2x, d2y, d2z)
        return jnp.stack(phis_f), jnp.stack(phis_b)

    T = topo.capacity
    C = chunk_size(T, chunk)
    K = T // C
    nbr_chunks = topo.nbr.reshape(K, C, 27)
    vx = vel[0].reshape(K, C, TILE)
    vy = vel[1].reshape(K, C, TILE)
    vz = vel[2].reshape(K, C, TILE)
    pf, pb = jax.lax.map(body, (nbr_chunks, vx, vy, vz))
    # [K, F, C, 512] -> [F, T, 512]
    F = len(fields)
    pf = jnp.moveaxis(pf, 0, 1).reshape(F, K * C, TILE)
    pb = jnp.moveaxis(pb, 0, 1).reshape(F, K * C, TILE)
    return pf, pb


# Transient-memory governors. Both are byte caps on XLA temporaries that
# switch to a lower-peak, bit-identical form above them; neither engages
# below 1024^3-class domains. Their values predate any measurement on this
# device and are to be re-derived from memory_stats() at the 1024^3 cell.
#
# Above this many bytes for the stacked [6, F, T, 512] face views, the
# clamp switches to the one-direction-at-a-time form.
CLAMP_VIEWS_BUDGET = 2 * 1024**3

# Per-batch budget for the ~4 field-sized BFECC transients each advected
# scalar keeps live until its clamp (see advect_scalars_fused): a
# 1024^3-class domain (~2 GB per field-transient set) runs one scalar per
# batch, bench-class domains stay single-batch.
ADVECT_TRANSIENT_BUDGET = 3 * 1024**3


def _minmax_clamp_multi(topo, phi0s, phi_fs, corrs):
    """BFECC min-max clamp over F stacked fields [F,T,512]: clamp each
    corrected value to [min, max] over its voxel, 6 face neighbors, and
    phiF (Kernel.cu:249-261); out-of-domain neighbors contribute background
    0. One row gather feeds all 6F face views (vs ~6F dispatched gathers);
    at-scale domains use the memory-lean per-direction reduction instead."""
    lo = jnp.minimum(phi0s, phi_fs)
    hi = jnp.maximum(phi0s, phi_fs)
    if 6 * phi0s.size * 4 > CLAMP_VIEWS_BUDGET:
        mins, maxs = sh.face_minmax_multi(topo, phi0s)
        lo = jnp.minimum(lo, mins)
        hi = jnp.maximum(hi, maxs)
    else:
        views = sh.face_views_multi(topo, phi0s)  # [6,F,T,512]
        lo = jnp.minimum(lo, jnp.min(views, axis=0))
        hi = jnp.maximum(hi, jnp.max(views, axis=0))
    return jnp.clip(corrs, lo, hi)


def _bfecc_limit_blocks(topo, phi0s, pfs, pbs):
    """At-scale BFECC limiter: bounds + correction + clip fused per ROW
    BLOCK, so no field-sized lo/hi/corr transient is ever live. Bit-exact
    with the precomputed-bounds path (min/max are associative; the clip
    reads identical bounds). This is what lets radius-256 (269k tiles)
    fit: the precompute held 2 field-sized bounds arrays across the whole
    sampling pass and the clamp added corr + lo + hi full-size temps."""
    F, T, _ = phi0s.shape
    want = max(1, -(-(F * T * TILE * 4) // sh.MINMAX_VIEWS_BUDGET))
    nblk = 1
    while nblk < want and T % (nblk * 2) == 0:
        nblk *= 2
    packed = jnp.moveaxis(phi0s, 0, 1).reshape(T, F * TILE)
    nbr6 = jnp.stack([topo.nbr[:, sh.d_of(off)] for off in sh.FACE_DIRS],
                     axis=1)
    B = T // nblk

    def body(k, out):
        r0 = k * B
        ph = jax.lax.dynamic_slice(phi0s, (0, r0, 0), (F, B, TILE))
        pf = jax.lax.dynamic_slice(pfs, (0, r0, 0), (F, B, TILE))
        pb = jax.lax.dynamic_slice(pbs, (0, r0, 0), (F, B, TILE))
        nb = jax.lax.dynamic_slice(nbr6, (r0, 0), (B, 6))
        mins = maxs = None
        for i, off in enumerate(sh.FACE_DIRS):
            mask, s_in, s_fix = sh._DIRS[off]
            nbr = jnp.take(packed, nb[:, i], axis=0)
            nbr = jnp.moveaxis(nbr.reshape(B, F, TILE), 1, 0)
            view = jnp.where(mask, jnp.roll(nbr, s_fix, axis=-1),
                             jnp.roll(ph, s_in, axis=-1))
            mins = view if mins is None else jnp.minimum(mins, view)
            maxs = view if maxs is None else jnp.maximum(maxs, view)
            # serialize the six gathers (identity, bit-exact) so a block
            # never holds them all at once
            mins, nb = jax.lax.optimization_barrier((mins, nb))
        corr = pf + 0.5 * (ph - pb)
        lo = jnp.minimum(jnp.minimum(ph, mins), pf)
        hi = jnp.maximum(jnp.maximum(ph, maxs), pf)
        return jax.lax.dynamic_update_slice(
            out, jnp.clip(corr, lo, hi), (0, r0, 0))

    return jax.lax.fori_loop(0, nblk, body, jnp.zeros_like(phi0s))


def _bfecc_limit(topo, phi0s, pf, pb):
    """The BFECC correction + limiter for F stacked fields: corrected =
    clip(pf + 0.5 (phi0 - pb), bounds) with bounds = min/max over {phi0,
    6 face neighbors, pf} (Kernel.cu:249-261). At scale the fused block
    form runs (no field-sized transients), below it the one-shot form."""
    if phi0s.size * 4 * 2 > sh.MINMAX_VIEWS_BUDGET:
        return _bfecc_limit_blocks(topo, phi0s, pf, pb)
    corrs = pf + 0.5 * (phi0s - pb)
    return _minmax_clamp_multi(topo, phi0s, pf, corrs)


def advect_scalars_fused(
    topo: Topology,
    vel: jax.Array,
    scalars: Dict[str, jax.Array],
    dt: float,
    inv_dx: float,
    sdf: Optional[jax.Array] = None,
    chunk: int = DEFAULT_CHUNK,
    trace_order: int = 1,
) -> Dict[str, jax.Array]:
    """BFECC-advect every scalar field by ``vel`` [3,T,512], sharing trace
    corners across fields (the fused advect_scalars kernel)."""
    if not scalars:
        return {}
    names = sorted(scalars)
    fields = [scalars[n] for n in names]
    # At-scale governor: each advected field keeps ~4 field-sized transients
    # live (phiF, phiB, packed lo|hi) until its clamp completes. Advect +
    # combine in field batches so only one batch's transients coexist —
    # at 1024^3 (T~269k, 5 scalars) this is the difference between ~11 GB
    # and ~4 GB of HLO temps. Small domains take one batch (no-op).
    per_field = 4 * fields[0].size * 4
    nbatch = max(1, min(len(fields),
                        int(ADVECT_TRANSIENT_BUDGET // per_field)))
    outs: list = []
    src_vel = vel
    for i in range(0, len(fields), nbatch):
        sub = fields[i:i + nbatch]
        pf, pb = _advect_chunked(
            topo, src_vel, sub, dt * inv_dx, sdf, chunk, trace_order
        )
        phi0s = jnp.stack(sub)
        clamped = _bfecc_limit(topo, phi0s, pf, pb)
        outs.extend(clamped[j] for j in range(len(sub)))
        if i + nbatch < len(fields):
            # batches are data-independent — barrier-chain them (identity)
            # so batch i+1's transients start only after batch i's clamp
            # retires (see shifts.neighbor_sum; at-scale OOM otherwise)
            outs[-1], src_vel = jax.lax.optimization_barrier(
                (outs[-1], src_vel))
    return {n: outs[i] for i, n in enumerate(names)}


def advect_scalar(
    topo: Topology,
    vel: jax.Array,
    field: jax.Array,
    dt: float,
    inv_dx: float,
    sdf: Optional[jax.Array] = None,
    chunk: int = DEFAULT_CHUNK,
    trace_order: int = 1,
) -> jax.Array:
    """Single-field BFECC advection (the standalone HNanoAdvect node path)."""
    return advect_scalars_fused(
        topo, vel, {"f": field}, dt, inv_dx, sdf, chunk, trace_order
    )["f"]


def advect_velocity(
    topo: Topology,
    vel: jax.Array,
    dt: float,
    inv_dx: float,
    sdf: Optional[jax.Array] = None,
    chunk: int = DEFAULT_CHUNK,
    trace_order: int = 1,
) -> jax.Array:
    """BFECC self-advection of velocity with per-component clamping and the
    reference's near-boundary no-slip tail (Kernel.cu:354-453)."""
    from hnanosolver_tpu.ops import collision as col

    if 3 * 4 * vel[0].size * 4 > ADVECT_TRANSIENT_BUDGET:
        # At-scale governor (see advect_scalars_fused): advect one component
        # per pass — as a scalars-mode field, since the in-kernel re-trace
        # still needs all three components sampled at the back position —
        # so only one component's phiF/phiB/limiter transients are live.
        # Sampling math is identical (same corners, same weights); costs
        # two extra back-pass fields per call.
        comps = []
        src_vel = vel
        for j in range(3):
            pf, pb = _advect_chunked(
                topo, src_vel, [src_vel[j]], dt * inv_dx, sdf, chunk,
                trace_order,
            )
            o = _bfecc_limit(topo, src_vel[j][None], pf, pb)
            comp = o[0]
            if j < 2:  # barrier-chain independent component passes
                comp, src_vel = jax.lax.optimization_barrier((comp, src_vel))
            comps.append(comp)
        out = jnp.stack(comps)
    else:
        fields = [vel[0], vel[1], vel[2]]
        pf, pb = _advect_chunked(
            topo, vel, fields, dt * inv_dx, sdf, chunk, trace_order,
            fields_are_velocity=True,
        )
        out = _bfecc_limit(topo, vel, pf, pb)

    if sdf is not None:
        # advect_vector's tail: gate at 0.1 but blend with 1 - sdf/1.5
        # (Kernel.cu:433-450) — a reference quirk we preserve.
        out = col.enforce_collision(
            topo, out, sdf, inv_dx, margin=0.1, blend_denom=1.5
        )
    return out

"""Flat-layout neighbor access: the stencil engine every hot op builds on.

Fields are ``[T, 512]`` (core/layout.py). Three access patterns, built from
rolls along the row, contiguous row gathers and batched in-row gathers:

- :func:`shifted_views` — the six +-1 face-shifted views: lane roll for the
  in-tile part, one full-row neighbor gather + roll + masked select for the
  boundary plane. This is the 7-point-stencil workhorse (pressure sweeps,
  divergence, gradients, curl, clamps).
- :func:`neighbor_table` — the 27-neighborhood as one ``[T, 27*512]`` array
  (one contiguous row gather).
- :func:`offset_view` / :func:`gather_table` — reads at arbitrary integer
  offsets or per-voxel dynamic positions within the 27-neighborhood, as
  batched in-row gathers from the neighbor table.

Background semantics: row 0 of every field is the all-zero null tile, and
absent neighbors point at row 0, so out-of-domain reads are exact zeros —
the reference's "offset 0 => background" rule
(`/root/reference/src/Utils/Stencils.hpp:81-89`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnanosolver_tpu.core.layout import COL, CX, CY, CZ, TILE
from hnanosolver_tpu.core.topology import Topology

# direction -> (boundary mask, in-tile roll, boundary fix roll)
# jnp.roll(p, s, 1)[col] == p[col - s]
_DIRS: Dict[Tuple[int, int, int], tuple] = {
    (1, 0, 0): (CX == 7, -64, 448),
    (-1, 0, 0): (CX == 0, 64, -448),
    (0, 1, 0): (CY == 7, -8, 56),
    (0, -1, 0): (CY == 0, 8, -56),
    (0, 0, 1): (CZ == 7, -1, 7),
    (0, 0, -1): (CZ == 0, 1, -7),
}

FACE_DIRS = tuple(_DIRS)


def d_of(off) -> int:
    return (off[0] + 1) * 9 + (off[1] + 1) * 3 + (off[2] + 1)


def shifted_view(topo: Topology, f: jax.Array, off) -> jax.Array:
    """One +-1 face-shifted view of ``f [T,512]``."""
    mask, s_in, s_fix = _DIRS[tuple(off)]
    n = jnp.take(f, topo.nbr[:, d_of(off)], axis=0)
    return jnp.where(mask, jnp.roll(n, s_fix, axis=1), jnp.roll(f, s_in, axis=1))


def shifted_views(topo: Topology, f: jax.Array, dirs=FACE_DIRS):
    return {off: shifted_view(topo, f, off) for off in dirs}


# above this many bytes of [6, T, 512] stacked views, neighbor_sum
# accumulates one direction at a time. A memory cap that engages only at
# 1024^3-class domains; its value predates any measurement on this device
# (re-derive from memory_stats() at the 1024^3 cell).
NBRSUM_VIEWS_BUDGET = 2 * 1024**3


def neighbor_sum(topo: Topology, f: jax.Array) -> jax.Array:
    """Sum of the six face neighbors (7-point stencil helper). One row
    gather for all six directions; the left-associated add order matches
    the per-direction formulation and the Pallas sweep kernel
    (ops/rbgs_sweep.py) bit-exactly. At-scale domains accumulate
    per direction (same order, bit-exact) to cap the transient."""
    if 6 * f.size * 4 > NBRSUM_VIEWS_BUDGET:
        # The six gathers are data-independent, so without a barrier XLA's
        # scheduler runs them all before the adds and the whole [6,T,512]
        # transient materializes anyway (the 1024^3 out-of-memory case).
        # optimization_barrier is an identity that threads ``f``
        # through each accumulation, forcing gather k+1 after add k:
        # peak = acc + one view instead of six views.
        acc = None
        src = f
        for off in FACE_DIRS:
            v = shifted_view(topo, src, off)
            acc = v if acc is None else acc + v
            acc, src = jax.lax.optimization_barrier((acc, src))
        return acc
    v = face_views_multi(topo, f[None])[:, 0]
    return v[0] + v[1] + v[2] + v[3] + v[4] + v[5]


# Transient budget for face_minmax_multi: above this, the bounds run in
# sequential ROW BLOCKS (a fori_loop writing into preallocated outputs) so
# only block-sized view/gather temps are live. At 1024^3 even single-field
# [1, T, 512] view temps are ~0.5 GB each. A memory cap that engages only
# at 1024^3-class domains; its value predates any measurement on this
# device (re-derive from memory_stats() at the 1024^3 cell).
MINMAX_VIEWS_BUDGET = 256 * 1024 * 1024


def _plane_maps(F: int):
    """Static lane maps for the face-plane-packed bounds gather: a face
    view consumes only the 64-lane plane of each neighbor row that touches
    the boundary, so gather THAT plane instead of the full row (8x fewer
    gathered bytes). Per direction: (boundary mask [512]
    bool, plane columns [F*64] into packed fields, expansion index [512]
    mapping boundary lanes to their plane slot)."""
    maps = []
    for off in FACE_DIRS:
        mask, s_in, s_fix = _DIRS[off]
        mnp = np.asarray(mask).reshape(-1)
        bl = np.nonzero(mnp)[0]  # 64 boundary (dest) lanes
        src_l = (bl - s_fix) % TILE  # the neighbor's contributing plane
        pcols = (np.arange(F)[:, None] * TILE + src_l[None]).reshape(-1)
        exp_idx = np.zeros(TILE, np.int64)
        exp_idx[bl] = np.arange(64)
        # NUMPY, not jnp: jnp.asarray of host data inside a trace yields a
        # TRACER on this JAX version, so a map first built inside one jit
        # poisons every later consumer. numpy constants stay constants
        # everywhere.
        maps.append((mnp, int(s_in), pcols.astype(np.int32),
                     exp_idx.astype(np.int32)))
    return maps


def face_minmax_multi(topo: Topology, fields: jax.Array):
    """Per-voxel (min, max) over the six face-shifted views of F stacked
    fields. Byte-minimal: per direction, only each neighbor row's 64-lane
    touching plane is gathered (8x fewer bytes than full rows; the in-tile
    part is a lane roll of the fields themselves). Above
    MINMAX_VIEWS_BUDGET the bounds run in sequential row blocks
    (barrier-chained) so only block-sized temps are live — at 1024^3 even
    single-field [1, T, 512] view temps are ~0.5 GB."""
    F, T, _ = fields.shape
    nblk = 1
    if F * T * TILE * 4 > MINMAX_VIEWS_BUDGET:
        # largest power-of-two block count that divides T (capacity is a
        # multiple of the 512-tile chunk, so small powers always divide)
        want = -(-(F * T * TILE * 4) // MINMAX_VIEWS_BUDGET)
        while nblk < want and T % (nblk * 2) == 0:
            nblk *= 2

    maps = _plane_maps(F)
    packed = jnp.moveaxis(fields, 0, 1).reshape(T, F * TILE)
    nbr6 = jnp.stack([topo.nbr[:, d_of(off)] for off in FACE_DIRS], axis=1)

    if nblk <= 1:
        # ONE fused lane-extraction pass for all six directions' planes;
        # gathers then move only the used 64 lanes per row
        allcols = jnp.concatenate([m[2] for m in maps])
        P = jnp.take(packed, allcols, axis=1)  # [T, 6*F*64]
        mins = maxs = None
        for i, (mnp, s_in, _pc, _exp) in enumerate(maps):
            g = jnp.take(P[:, i * F * 64:(i + 1) * F * 64],
                         nbr6[:, i], axis=0)  # [T, F*64] plane values
            g = g.reshape(T, F, 64).transpose(1, 0, 2)
            # expand the 64-lane plane to the 512-lane row as a pure
            # BROADCAST (the plane is constant along its face axis; packed
            # order is ascending boundary-lane = the remaining two axes in
            # lane order) — a take with a general lane permutation here
            # does not fuse and cost a full field-size pass per direction
            axis = max(range(3), key=lambda a: abs(FACE_DIRS[i][a]))
            if axis == 0:  # plane (y,z): tile along x
                ge = jnp.broadcast_to(g[:, :, None, :], (F, T, 8, 64))
            elif axis == 1:  # plane (x,z): tile along y
                ge = jnp.broadcast_to(
                    g.reshape(F, T, 8, 1, 8), (F, T, 8, 8, 8))
            else:  # plane (x,y): tile along z
                ge = jnp.broadcast_to(
                    g.reshape(F, T, 8, 8, 1), (F, T, 8, 8, 8))
            ge = ge.reshape(F, T, TILE)
            view = jnp.where(mnp, ge, jnp.roll(fields, s_in, axis=-1))
            mins = view if mins is None else jnp.minimum(mins, view)
            maxs = view if maxs is None else jnp.maximum(maxs, view)
        return mins, maxs

    # At-scale block form: NO plane-packed resident (P is ~6/8 of the
    # field bytes, too much at 1024^3); gather full rows per block,
    # barrier-chained.
    B = T // nblk

    def block(fields_b, nbr_b):
        mins = maxs = None
        for i, off in enumerate(FACE_DIRS):
            mask, s_in, s_fix = _DIRS[off]
            nbr = jnp.take(packed, nbr_b[:, i], axis=0)
            nbr = jnp.moveaxis(nbr.reshape(-1, F, TILE), 1, 0)
            view = jnp.where(mask, jnp.roll(nbr, s_fix, axis=-1),
                             jnp.roll(fields_b, s_in, axis=-1))
            mins = view if mins is None else jnp.minimum(mins, view)
            maxs = view if maxs is None else jnp.maximum(maxs, view)
            # serialize the six gathers (identity, bit-exact) so a block
            # never holds them all at once
            mins, nbr_b = jax.lax.optimization_barrier((mins, nbr_b))
        return mins, maxs

    def body(k, acc):
        mins, maxs = acc
        r0 = k * B
        fb = jax.lax.dynamic_slice(fields, (0, r0, 0), (F, B, TILE))
        nb = jax.lax.dynamic_slice(nbr6, (r0, 0), (B, 6))
        mb, xb = block(fb, nb)
        mins = jax.lax.dynamic_update_slice(mins, mb, (0, r0, 0))
        maxs = jax.lax.dynamic_update_slice(maxs, xb, (0, r0, 0))
        return mins, maxs

    init = (jnp.zeros_like(fields), jnp.zeros_like(fields))
    return jax.lax.fori_loop(0, nblk, body, init)


def face_views_multi(topo: Topology, fields: jax.Array) -> jax.Array:
    """All six face-shifted views of F stacked fields with ONE row gather.

    ``fields [F,T,512]`` -> ``[6,F,T,512]`` in FACE_DIRS order. The separate
    per-field per-direction ``shifted_view`` calls cost ~6F dispatched
    gathers (~42 us each); this is one gather + fused rolls/selects, over
    fields packed [T, F*512] so each gathered row is ONE take row (gather
    cost is per-row-descriptor-bound: 6T descriptors instead of 6FT)."""
    F, T, _ = fields.shape
    packed = jnp.moveaxis(fields, 0, 1).reshape(T, F * TILE)
    cols = jnp.concatenate([topo.nbr[:, d_of(off)] for off in FACE_DIRS])
    nbr = jnp.take(packed, cols, axis=0).reshape(6, T, F, TILE)
    nbr = jnp.moveaxis(nbr, 2, 1)  # [6,F,T,512]
    views = []
    for i, off in enumerate(FACE_DIRS):
        mask, s_in, s_fix = _DIRS[off]
        views.append(
            jnp.where(
                mask,
                jnp.roll(nbr[i], s_fix, axis=-1),
                jnp.roll(fields, s_in, axis=-1),
            )
        )
    return jnp.stack(views)


def neighbor_table(topo: Topology, f: jax.Array) -> jax.Array:
    """[T, 27*512]: every tile's 3x3x3 neighborhood values, one row gather.
    Entry layout: d*512 + col with d = (dx+1)*9 + (dy+1)*3 + (dz+1)."""
    T = f.shape[0]
    return jnp.take(f, topo.nbr.reshape(-1), axis=0).reshape(T, 27 * TILE)


def table_index(cx, cy, cz):
    """In-neighborhood coords (each in [-8, 16)) -> index into the 27-table.
    Accepts [T,512] int32 arrays (per-voxel dynamic positions)."""
    ox = (cx + 8) >> 3  # 0,1,2
    oy = (cy + 8) >> 3
    oz = (cz + 8) >> 3
    d = (ox * 9 + oy * 3 + oz) * TILE
    return d + (cx & 7) * 64 + (cy & 7) * 8 + (cz & 7)


def gather_table(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Batched in-row gather: table [T, 13824], idx [T,512] -> [T,512]."""
    return jnp.take_along_axis(table, idx, axis=1)


def offset_view(topo: Topology, f: jax.Array, off) -> jax.Array:
    """f at a fixed integer offset, any |component| <= 8: a STATIC index
    vector into the 27-table (one row gather + one in-row gather)."""
    ox, oy, oz = (int(o) for o in off)
    assert all(-8 <= o <= 8 for o in (ox, oy, oz))
    if (ox, oy, oz) in _DIRS:
        return shifted_view(topo, f, (ox, oy, oz))
    table = neighbor_table(topo, f)
    idx = table_index(CX + ox, CY + oy, CZ + oz)
    return gather_table(table, jnp.broadcast_to(idx, f.shape))

"""Explicit slab decomposition: shard_map + ppermute ghost-tile exchange.

The reference is single-GPU (SURVEY §5.8); this is the multi-device
scale-out design (SURVEY §7.2 phase 5, BASELINE config 5), on a 1-D mesh
whose devices are all linked to each other (NVLink between the GPUs of one
host), so the mesh follows the decomposition alone:

- Active tiles are partitioned into D contiguous **x-slabs** (packed keys
  sort x-major, so slab = contiguous key range) balanced by tile count,
  with slab boundaries snapped to x-layers so every cross-slab neighbor
  lives on an adjacent device.
- Each device's local tile table is ``[null, ghosts_lo, local, ghosts_hi,
  pad..., trash]`` — still key-sorted, so all single-device machinery
  (sorted lookup, neighbor table, halo gathers, local samplers) runs
  unchanged on the local slice.
- **Ghost refresh** = one ``lax.ppermute`` per direction along the mesh:
  owners push their boundary-layer tiles into the neighbors' ghost rows.
  This is the distributed analog of the reference's shared-memory halo load
  (`/root/reference/src/Cuda/Kernel.cu:539-548`) — ghosts refresh before
  every halo-consuming op and every pressure sweep.
- Compute runs redundantly on ghost rows and is masked out of outputs; only
  the refresh communicates. Per-step traffic = boundary layers only
  (2 x-layers per device per refresh).

Capacities are padded to a common power-of-two so arrays stack to
``[D, Tl, ...]`` and shard on axis 0 of a 1-D mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hnanosolver_tpu.config import SolverParams
from hnanosolver_tpu.core import coords as C
from hnanosolver_tpu.core.topology import Topology, build_topology
from hnanosolver_tpu.fields import FieldState


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SlabTopology:
    """Stacked per-device local tables, sharded on axis 0 under shard_map."""

    keys: jax.Array  # [D, Tl]
    origins: jax.Array  # [D, Tl, 3]
    nbr: jax.Array  # [D, Tl, 27]
    n_rows: jax.Array  # [D] rows in use (null + ghosts + local)
    local_mask: jax.Array  # [D, Tl] 1.0 on OWNED rows only
    send_lo: jax.Array  # [D, G] local rows whose values go to device d-1
    send_hi: jax.Array  # [D, G] local rows whose values go to device d+1
    recv_lo: jax.Array  # [D, G] ghost rows receiving from d-1 (trash-padded)
    recv_hi: jax.Array  # [D, G] ghost rows receiving from d+1

    @property
    def n_devices(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def tree_flatten(self):
        return (
            self.keys, self.origins, self.nbr, self.n_rows, self.local_mask,
            self.send_lo, self.send_hi, self.recv_lo, self.recv_hi,
        ), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch)

    def make_refresh_local(self, axis: str, ex) -> "callable":
        """Refresh closure from this device's exchange leaves (leaf order
        after the 5 core arrays) — the decomposition-specific half of
        ``sharded_step``; BoxTopology (parallel/boxes.py) provides the
        multi-phase 2-D/3-D counterpart."""
        send_lo, send_hi, recv_lo, recv_hi = ex
        return make_refresh(
            axis, send_lo, send_hi, recv_lo, recv_hi, self.n_devices
        )


def _snap_partition(xs: np.ndarray, n_dev: int) -> List[Tuple[int, int]]:
    """Split sorted x-layer values into n_dev contiguous layer ranges with
    balanced tile counts. Returns [(x_min, x_max_inclusive)] per device."""
    layers, counts = np.unique(xs, return_counts=True)
    if len(layers) < n_dev:
        raise ValueError(
            f"need >= {n_dev} x tile-layers to shard over {n_dev} devices, "
            f"have {len(layers)}"
        )
    total = counts.sum()
    cum = np.cumsum(counts)
    # cut after the layer whose cumulative count is closest to d*total/D,
    # keeping at least one layer per device on both sides of every cut.
    cuts = [0]
    for d in range(1, n_dev):
        ideal = d * total / n_dev
        lo = cuts[-1] + 1  # leave >= 1 layer for this slab
        hi = len(layers) - (n_dev - d)  # leave >= 1 layer per remaining slab
        cand = np.arange(lo, hi + 1)
        best = cand[np.argmin(np.abs(cum[cand - 1] - ideal))]
        cuts.append(int(best))
    cuts.append(len(layers))
    return [
        (int(layers[cuts[d]]), int(layers[cuts[d + 1] - 1])) for d in range(n_dev)
    ]


def build_slabs(topo: Topology, n_devices: int, capacity: Optional[int] = None) -> SlabTopology:
    """Host-side: partition an existing Topology into per-device local tables
    with ghost layers and exchange index maps."""
    n = int(topo.n_active)
    tiles = np.asarray(topo.origins[1 : n + 1])  # sorted by key (x-major)
    bounds = _snap_partition(tiles[:, 0], n_devices)

    locals_: List[np.ndarray] = []
    ghosts_lo: List[np.ndarray] = []
    ghosts_hi: List[np.ndarray] = []
    for d, (x0, x1) in enumerate(bounds):
        own = tiles[(tiles[:, 0] >= x0) & (tiles[:, 0] <= x1)]
        locals_.append(own)
        if d > 0:
            px0, px1 = bounds[d - 1]
            ghosts_lo.append(tiles[tiles[:, 0] == px1])  # prev device's top layer
        else:
            ghosts_lo.append(np.zeros((0, 3), np.int32))
        if d < n_devices - 1:
            nx0, nx1 = bounds[d + 1]
            ghosts_hi.append(tiles[tiles[:, 0] == nx0])
        else:
            ghosts_hi.append(np.zeros((0, 3), np.int32))

    n_rows_needed = max(
        1 + len(g0) + len(lc) + len(g1)
        for g0, lc, g1 in zip(ghosts_lo, locals_, ghosts_hi)
    )
    cap = capacity or 16
    while cap < n_rows_needed + 1:  # +1 for the trash row at the end
        cap *= 2
    G = max(max(len(g) for g in ghosts_lo), max(len(g) for g in ghosts_hi), 1)
    trash = cap - 1

    D = n_devices
    keys = np.full((D, cap), C.PAD_KEY, np.int32)
    origins = np.full((D, cap, 3), 1 << 20, np.int32)
    nbr = np.zeros((D, cap, 27), np.int32)
    n_rows = np.zeros((D,), np.int32)
    local_mask = np.zeros((D, cap), np.float32)
    send_lo = np.zeros((D, G), np.int32)
    send_hi = np.zeros((D, G), np.int32)
    recv_lo = np.full((D, G), trash, np.int32)
    recv_hi = np.full((D, G), trash, np.int32)

    offs = np.array(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        np.int32,
    )

    row_of: List[dict] = []
    for d in range(D):
        table = np.concatenate([ghosts_lo[d], locals_[d], ghosts_hi[d]], axis=0)
        k = C.pack_keys_np(table)
        order = np.argsort(k)  # ghosts_lo < local < ghosts_hi already, but be safe
        table, k = table[order], k[order]
        m = len(table)
        keys[d, 0] = C.NULL_KEY
        keys[d, 1 : m + 1] = k
        origins[d, 1 : m + 1] = table
        n_rows[d] = m + 1
        # neighbor table within the local key set
        nk = C.pack_keys_np(table[:, None, :] + offs[None, :, :])
        pos = np.searchsorted(k, nk)
        posc = np.minimum(pos, m - 1)
        found = k[posc] == nk
        nbr[d, 1 : m + 1] = np.where(found, posc + 1, 0)
        rows = {int(kk): i + 1 for i, kk in enumerate(k)}
        row_of.append(rows)
        x0, x1 = bounds[d]
        own_mask = (table[:, 0] >= x0) & (table[:, 0] <= x1)
        local_mask[d, 1 : m + 1] = own_mask.astype(np.float32)

    for d in range(D):
        if d > 0:
            g = ghosts_lo[d]  # owned by d-1 (its top layer)
            gk = C.pack_keys_np(g)
            for i, kk in enumerate(gk):
                recv_lo[d, i] = row_of[d][int(kk)]
                send_hi[d - 1, i] = row_of[d - 1][int(kk)]
        if d < D - 1:
            g = ghosts_hi[d]
            gk = C.pack_keys_np(g)
            for i, kk in enumerate(gk):
                recv_hi[d, i] = row_of[d][int(kk)]
                send_lo[d + 1, i] = row_of[d + 1][int(kk)]

    return SlabTopology(
        keys=jnp.asarray(keys),
        origins=jnp.asarray(origins),
        nbr=jnp.asarray(nbr),
        n_rows=jnp.asarray(n_rows),
        local_mask=jnp.asarray(local_mask),
        send_lo=jnp.asarray(send_lo),
        send_hi=jnp.asarray(send_hi),
        recv_lo=jnp.asarray(recv_lo),
        recv_hi=jnp.asarray(recv_hi),
    )


def scatter_state(topo: Topology, slab: SlabTopology, state: FieldState) -> FieldState:
    """Re-layout a global FieldState into stacked per-device local tables
    (host-side, by key match; ghosts filled too)."""
    D, Tl = slab.keys.shape

    pos = jnp.searchsorted(topo.keys, slab.keys.reshape(-1)).astype(jnp.int32)
    pos = jnp.minimum(pos, topo.capacity - 1)
    found = topo.keys[pos] == slab.keys.reshape(-1)
    rows = jnp.where(found, pos, 0)

    def remap(field):  # scalars [T,512] -> [D,Tl,512]
        return jnp.take(field, rows, axis=0).reshape((D, Tl) + field.shape[1:])

    # velocity [3,T,512] -> [D,3,Tl,512] (device axis outermost for sharding)
    vel = jnp.take(state.velocity, rows, axis=1).reshape(3, D, Tl, -1)
    return FieldState(
        velocity=jnp.moveaxis(vel, 0, 1),
        scalars={k: remap(v) for k, v in state.scalars.items()},
    )


def gather_state(topo: Topology, slab: SlabTopology, state: FieldState) -> FieldState:
    """Inverse of scatter_state: merge owned rows back into the global table."""
    D, Tl = slab.keys.shape
    flat_keys = np.asarray(slab.keys).reshape(-1)
    owned = np.asarray(slab.local_mask).reshape(-1) > 0
    gk = np.asarray(topo.keys)
    pos = np.searchsorted(gk, flat_keys[owned])
    rows = jnp.asarray(pos.astype(np.int32))

    sel = jnp.asarray(np.flatnonzero(owned))

    def merge(field):  # [D,Tl,512] -> [T,512]
        flat = field.reshape((D * Tl,) + field.shape[2:])
        out = jnp.zeros((topo.capacity,) + field.shape[2:], field.dtype)
        return out.at[rows].set(flat[sel])

    # velocity [D,3,Tl,512] -> [3,T,512]
    velf = jnp.moveaxis(state.velocity, 1, 0).reshape(3, D * Tl, -1)
    velo = jnp.zeros((3, topo.capacity, velf.shape[-1]), velf.dtype)
    velo = velo.at[:, rows].set(velf[:, sel])
    return FieldState(
        velocity=velo,
        scalars={k: merge(v) for k, v in state.scalars.items()},
    )


# ---------------------------------------------------------------------------
# Sharded multigrid: fine level sharded, coarse levels replicated
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlabHierarchy:
    """Multigrid hierarchy for a slab decomposition.

    The fine level stays sharded; every coarse level is REPLICATED on all
    devices: each device restricts only its OWNED fine tiles into the global
    coarse table (children map -> 0 elsewhere), one ``psum`` combines the
    partial restrictions, and the coarse V-cycle then runs identically
    everywhere (coarse work is 8^-k of fine — cheaper to replicate than to
    exchange). Prolongation gathers from the replicated correction by each
    local tile's global parent row."""

    children_local: jax.Array  # [D, Tc, 8] local fine row per octant (0 = not owned here)
    parent_global: jax.Array  # [D, Tl] global coarse row of each local tile
    octant_local: jax.Array  # [D, Tl]
    coarse_level: object  # MGLevel of the global level 1 (replicated; maps unused)
    rest: tuple  # plain MGLevels below level 1 (replicated)


def build_slab_hierarchy(
    topo: Topology, slab: SlabTopology, levels: int
) -> SlabHierarchy:
    """Host-side: per-device restriction/prolongation maps into the global
    coarse hierarchy of ``topo``."""
    from hnanosolver_tpu.ops.multigrid import build_hierarchy

    hier = build_hierarchy(topo, levels)
    lvl1 = hier[0]
    D, Tl = slab.keys.shape
    Tc = lvl1.topo.capacity
    gkeys = np.asarray(topo.keys)
    children_g = np.asarray(lvl1.children)
    parent_g = np.asarray(lvl1.parent)
    octant_g = np.asarray(lvl1.octant)
    owned = np.asarray(slab.local_mask) > 0
    skeys = np.asarray(slab.keys)

    children_local = np.zeros((D, Tc, 8), np.int32)
    parent_local = np.zeros((D, Tl), np.int32)
    octant_local = np.zeros((D, Tl), np.int32)
    for d in range(D):
        pos = np.minimum(np.searchsorted(gkeys, skeys[d]), len(gkeys) - 1)
        valid = (
            (gkeys[pos] == skeys[d])
            & (skeys[d] != C.PAD_KEY)
            & (skeys[d] != C.NULL_KEY)
        )
        g = np.where(valid, pos, 0)
        parent_local[d] = np.where(valid, parent_g[g], 0)
        octant_local[d] = np.where(valid, octant_g[g], 0)
        g2l = np.zeros(topo.capacity, np.int32)
        own_rows = np.flatnonzero(owned[d])
        g2l[g[own_rows]] = own_rows
        children_local[d] = g2l[children_g]

    return SlabHierarchy(
        children_local=jnp.asarray(children_local),
        parent_global=jnp.asarray(parent_local),
        octant_local=jnp.asarray(octant_local),
        coarse_level=lvl1,
        rest=tuple(hier[1:]),
    )


# ---------------------------------------------------------------------------
# Device-local step under shard_map
# ---------------------------------------------------------------------------


def _local_topo(slab_slice) -> Topology:
    keys, origins, nbr, n_rows = slab_slice
    return Topology(keys=keys, origins=origins, nbr=nbr, n_active=n_rows - 1)


def make_refresh(axis: str, send_lo, send_hi, recv_lo, recv_hi, n_devices: int):
    """Ghost refresh closure for use inside shard_map: one ppermute per
    direction pushes boundary-layer tile values into neighbor ghost rows.
    Handles both [T,512] scalars and [3,T,512] velocity (row axis differs)."""
    fwd = [(i, i + 1) for i in range(n_devices - 1)]
    bwd = [(i + 1, i) for i in range(n_devices - 1)]

    def refresh(field: jax.Array) -> jax.Array:
        ax = 1 if field.ndim == 3 else 0  # velocity is channel-major
        up = jax.lax.ppermute(jnp.take(field, send_hi, axis=ax), axis, fwd)
        dn = jax.lax.ppermute(jnp.take(field, send_lo, axis=ax), axis, bwd)
        # trash-row padding absorbs unused slots; row 0 (null) is never a
        # recv target so the background invariant holds.
        if ax == 0:
            return field.at[recv_lo].set(up).at[recv_hi].set(dn)
        return field.at[:, recv_lo].set(up).at[:, recv_hi].set(dn)

    return refresh


def sharded_step(
    mesh: Mesh,
    slab: SlabTopology,
    params: SolverParams,
    emit_fn=None,
    axis: str = "x",
    hierarchy: Optional[SlabHierarchy] = None,
):
    """jit(shard_map(...)) full step over stacked slab state, running the
    ONE pipeline implementation (``solver.step_impl``) with the ppermute
    ghost refresh injected as its halo hook. Returns fn(slab, state) ->
    state with every field sharded on the device axis.

    ``emit_fn(topo, state) -> state``: optional per-frame sourcing applied
    before the step (e.g. ``partial(models.plume.emit, cfg=cfg, dt=dt)``).
    ``hierarchy``: from ``build_slab_hierarchy`` when params selects the
    multigrid pressure solver."""
    try:
        from jax import shard_map  # jax >= 0.5
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    from hnanosolver_tpu.ops.multigrid import MGLevel
    from hnanosolver_tpu.solver import step_impl

    use_mg = params.pressure_solver == "mg"
    if use_mg and hierarchy is None:
        raise ValueError("pressure_solver='mg' needs a build_slab_hierarchy()")

    D = slab.n_devices

    def local_step(slab_arrs, hier_maps, vel, scalars):
        # shard_map hands each [D, ...] array as its local [1, ...] block.
        # Leaf contract (SlabTopology AND BoxTopology): 5 core arrays, then
        # the decomposition-specific exchange maps.
        keys, origins, nbr, n_rows, local_mask = (a[0] for a in slab_arrs[:5])
        ex = tuple(a[0] for a in slab_arrs[5:])
        vel = vel[0]
        scalars = {k: v[0] for k, v in scalars.items()}
        n_rows = n_rows[()] if n_rows.ndim == 0 else n_rows
        topo = _local_topo((keys, origins, nbr, n_rows))
        refresh = slab.make_refresh_local(axis, ex)

        hier = ()
        coarse_reduce = None
        tol_reduce = None
        if use_mg:
            children, parent, octant = (a[0] for a in hier_maps)
            g = hierarchy.coarse_level  # replicated closure constants
            lvl1 = MGLevel(
                topo=g.topo, children=children, parent=parent,
                octant=octant, mask=g.mask,
            )
            hier = (lvl1,) + hierarchy.rest
            coarse_reduce = lambda rc: jax.lax.psum(rc, axis)  # noqa: E731
            # mesh-wide residual max for mg_tol: ghost rows carry WRONG
            # residuals (their outer neighbors are off-table -> read as
            # background 0), so mask to owned rows before the local max,
            # then pmax so every device stops on the same cycle
            tol_reduce = lambda r: jax.lax.pmax(  # noqa: E731
                jnp.max(jnp.abs(r) * local_mask[:, None]), axis)

        def refresh_state(s: FieldState) -> FieldState:
            return FieldState(
                velocity=refresh(s.velocity),
                scalars={k: refresh(v) for k, v in s.scalars.items()},
            )

        state = refresh_state(FieldState(velocity=vel, scalars=scalars))
        if emit_fn is not None:
            state = refresh_state(emit_fn(topo, state))

        out = step_impl(
            topo, state, params, hierarchy=hier, refresh=refresh,
            coarse_reduce=coarse_reduce, tol_reduce=tol_reduce,
        )

        m = local_mask[:, None]  # [Tl,1]
        return (
            (out.velocity * m[None])[None],  # [1,3,Tl,512]
            {k: (v * m)[None] for k, v in out.scalars.items()},
        )

    def step_fn(slab_in: SlabTopology, state: FieldState) -> FieldState:
        slab_leaves = tuple(slab_in.tree_flatten()[0])
        hier_maps = (
            (hierarchy.children_local, hierarchy.parent_global,
             hierarchy.octant_local)
            if use_mg else ()
        )
        scalars_spec = {k: P(axis) for k in state.scalars}
        fn = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                tuple(P(axis) for _ in slab_leaves),
                tuple(P(axis) for _ in hier_maps),
                P(axis),
                scalars_spec,
            ),
            out_specs=(P(axis), scalars_spec),
        )
        vel, scalars = fn(slab_leaves, hier_maps, state.velocity, state.scalars)
        return FieldState(velocity=vel, scalars=scalars)

    return jax.jit(step_fn)


def sharded_plume_step(
    mesh: Mesh,
    slab: SlabTopology,
    params: SolverParams,
    cfg=None,
    axis: str = "x",
    hierarchy: Optional[SlabHierarchy] = None,
):
    """Plume-model convenience wrapper over ``sharded_step``."""
    emit_fn = None
    if cfg is not None:
        from hnanosolver_tpu.models.plume import emit

        emit_fn = lambda topo, state: emit(topo, state, cfg, params.dt)  # noqa: E731
    return sharded_step(mesh, slab, params, emit_fn=emit_fn, axis=axis,
                        hierarchy=hierarchy)

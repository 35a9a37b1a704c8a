"""Box (2-D/3-D) domain decomposition: the pod-scale generalization of the
x-slab partition (``parallel/slab.py``).

A 1-D x-slab cut needs at least one x tile-layer per device, so a large
device count or a squat/flat domain breaks it. Here the
device grid is ``(Dx, Dy, Dz)`` and tiles are partitioned by GLOBAL layer
cuts per axis (tensor-product boxes): cuts along each partitioned axis are
shared by every device row/column, so each device has exactly one exchange
partner per face direction and ``lax.ppermute`` stays a plain permutation.

Corner/edge ghosts (the 27-point stencils read diagonal tiles) arrive by the
classic staged exchange — phases run x, then y, then z, and each later phase
sends rows that INCLUDE the ghost rows received by earlier phases, so corner
values propagate transitively in <= 3 ppermute pairs per refresh:

- phase x sends its boundary x-layer restricted to its own y/z box,
- phase y sends its boundary y-layer over the x-EXTENDED range,
- phase z sends its boundary z-layer over the x- and y-extended range.

Each device's local table is the key-sorted set of active tiles inside its
box extended by one ghost layer along every partitioned axis (full product,
corners included), so all single-device machinery runs unchanged — exactly
the slab design, generalized. ``sharded_step`` (parallel/slab.py) accepts a
BoxTopology anywhere it accepts a SlabTopology; scatter/gather and the
replicated-coarse multigrid hierarchy are shared unchanged.

Reference scope: the reference is single-GPU (SURVEY §5.8); this is the
scale-out path for domains a 1-D slab cut cannot split (SURVEY §7.2 phase
5). The device grid is a logical decomposition: with all-to-all links
(NVLink) it need not match any physical topology.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnanosolver_tpu.core import coords as C
from hnanosolver_tpu.core.topology import Topology

# re-exported conveniences: everything downstream of the decomposition is
# shared with the slab path (same array contract: keys/local_mask/...).
from hnanosolver_tpu.parallel.slab import (  # noqa: F401
    build_slab_hierarchy,
    gather_state,
    scatter_state,
    sharded_step,
)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BoxTopology:
    """Stacked per-device local tables + per-phase exchange maps.

    Leaf order matches SlabTopology's contract with ``sharded_step``: the
    first five leaves are (keys, origins, nbr, n_rows, local_mask); the rest
    are the exchange maps, interpreted by ``make_refresh_local``. ``perms``
    (static aux) holds per phase the forward/backward ppermute pairs over
    the FLATTENED device grid (d = ix*Dy*Dz + iy*Dz + iz)."""

    keys: jax.Array  # [D, Tl]
    origins: jax.Array  # [D, Tl, 3]
    nbr: jax.Array  # [D, Tl, 27]
    n_rows: jax.Array  # [D]
    local_mask: jax.Array  # [D, Tl] 1.0 on OWNED rows
    exchange: Tuple[jax.Array, ...]  # per phase: send_lo, send_hi, recv_lo,
    # recv_hi, each [D, G_phase] (send pads -> row 0; recv pads -> trash row)
    perms: Tuple[Tuple[Tuple[Tuple[int, int], ...],
                       Tuple[Tuple[int, int], ...]], ...]  # static
    grid: Tuple[int, int, int]  # static (Dx, Dy, Dz)

    @property
    def n_devices(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def tree_flatten(self):
        return (
            (self.keys, self.origins, self.nbr, self.n_rows, self.local_mask)
            + tuple(self.exchange)
        ), (self.perms, self.grid)

    @classmethod
    def tree_unflatten(cls, aux, ch):
        perms, grid = aux
        return cls(*ch[:5], exchange=tuple(ch[5:]), perms=perms, grid=grid)

    def make_refresh_local(self, axis: str, ex: Sequence[jax.Array]):
        """Refresh closure for use inside shard_map (``ex``: this device's
        exchange maps, 4 per phase, in leaf order). Phases APPLY IN ORDER —
        later sends read rows the earlier phases just refreshed, which is
        what carries edge/corner ghosts."""
        perms = self.perms

        def refresh(field: jax.Array) -> jax.Array:
            ax = 1 if field.ndim == 3 else 0  # velocity is channel-major
            for p, (fwd, bwd) in enumerate(perms):
                slo, shi, rlo, rhi = ex[4 * p: 4 * p + 4]
                up = jax.lax.ppermute(
                    jnp.take(field, shi, axis=ax), axis, list(fwd))
                dn = jax.lax.ppermute(
                    jnp.take(field, slo, axis=ax), axis, list(bwd))
                if ax == 0:
                    field = field.at[rlo].set(up).at[rhi].set(dn)
                else:
                    field = field.at[:, rlo].set(up).at[:, rhi].set(dn)
            return field

        return refresh


def _axis_cuts(vals: np.ndarray, n: int) -> List[Tuple[int, int]]:
    """Global balanced layer cuts along one axis: [(lo, hi_inclusive)] layer
    values per grid index, from the marginal tile counts (same rule as
    slab._snap_partition)."""
    layers, counts = np.unique(vals, return_counts=True)
    if len(layers) < n:
        raise ValueError(
            f"need >= {n} tile-layers along a partitioned axis, have "
            f"{len(layers)}"
        )
    total = counts.sum()
    cum = np.cumsum(counts)
    cuts = [0]
    for d in range(1, n):
        ideal = d * total / n
        lo = cuts[-1] + 1
        hi = len(layers) - (n - d)
        cand = np.arange(lo, hi + 1)
        best = cand[np.argmin(np.abs(cum[cand - 1] - ideal))]
        cuts.append(int(best))
    cuts.append(len(layers))
    return [(int(layers[cuts[d]]), int(layers[cuts[d + 1] - 1]))
            for d in range(n)]


def build_boxes(
    topo: Topology,
    grid: Tuple[int, int, int],
    capacity: Optional[int] = None,
) -> BoxTopology:
    """Partition an existing Topology over a ``(Dx, Dy, Dz)`` device grid.

    ``build_boxes(topo, (D, 1, 1))`` is the x-slab special case. Tensor cuts
    trade some balance for single-partner exchanges; ``local_mask`` row sums
    report the realized balance."""
    Dx, Dy, Dz = grid
    D = Dx * Dy * Dz
    n = int(topo.n_active)
    tiles = np.asarray(topo.origins[1: n + 1])

    bounds = [
        _axis_cuts(tiles[:, a], da) if da > 1 else
        [(int(tiles[:, a].min()), int(tiles[:, a].max()))]
        for a, da in enumerate(grid)
    ]

    def ext_sel(a: int, i: int) -> np.ndarray:
        """Mask over ``tiles`` for grid index i's EXTENDED range on axis a:
        own layer interval plus the adjacent boxes' boundary layer values
        (actual occupied layers, so gapped domains stay consistent on both
        sides of every exchange)."""
        lo, hi = bounds[a][i]
        v = tiles[:, a]
        sel = (v >= lo) & (v <= hi)
        if i > 0:
            sel |= v == bounds[a][i - 1][1]
        if i < len(bounds[a]) - 1:
            sel |= v == bounds[a][i + 1][0]
        return sel

    def own_sel(a: int, i: int) -> np.ndarray:
        lo, hi = bounds[a][i]
        return (tiles[:, a] >= lo) & (tiles[:, a] <= hi)

    def dev(ix: int, iy: int, iz: int) -> int:
        return (ix * Dy + iy) * Dz + iz

    # per-device local tile tables: extended box (product, corners included)
    tables: List[np.ndarray] = [None] * D
    owned: List[np.ndarray] = [None] * D
    for ix in range(Dx):
        sx, ox = ext_sel(0, ix), own_sel(0, ix)
        for iy in range(Dy):
            sy, oy = ext_sel(1, iy), own_sel(1, iy)
            for iz in range(Dz):
                sz, oz = ext_sel(2, iz), own_sel(2, iz)
                t = tiles[sx & sy & sz]
                k = C.pack_keys_np(t)
                order = np.argsort(k)
                tables[dev(ix, iy, iz)] = t[order]
                owned[dev(ix, iy, iz)] = (
                    (ox & oy & oz)[sx & sy & sz][order]
                )

    n_rows_needed = max(len(t) for t in tables) + 1
    cap = capacity or 16
    while cap < n_rows_needed + 1:  # +1 trash row
        cap *= 2
    trash = cap - 1

    keys = np.full((D, cap), C.PAD_KEY, np.int32)
    origins = np.full((D, cap, 3), 1 << 20, np.int32)
    nbr = np.zeros((D, cap, 27), np.int32)
    n_rows = np.zeros((D,), np.int32)
    local_mask = np.zeros((D, cap), np.float32)
    offs = np.array(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
         for dz in (-1, 0, 1)],
        np.int32,
    )
    row_of: List[dict] = []
    for d in range(D):
        t = tables[d]
        k = C.pack_keys_np(t)
        m = len(t)
        keys[d, 0] = C.NULL_KEY
        keys[d, 1: m + 1] = k
        origins[d, 1: m + 1] = t
        n_rows[d] = m + 1
        nk = C.pack_keys_np(t[:, None, :] + offs[None, :, :])
        pos = np.searchsorted(k, nk)
        posc = np.minimum(pos, m - 1)
        found = k[posc] == nk
        nbr[d, 1: m + 1] = np.where(found, posc + 1, 0)
        local_mask[d, 1: m + 1] = owned[d].astype(np.float32)
        row_of.append({int(kk): i + 1 for i, kk in enumerate(k)})

    # staged exchange maps: phase per partitioned axis, in x, y, z order.
    # The send SET for device i -> i+1 on axis a is its boundary layer
    # (bounds[a][i][1]) over the earlier axes' EXTENDED ranges and the later
    # axes' OWN ranges; the receiver's ghost rows are the identical tile set
    # (same global cut), so pairing by sorted key is consistent on both ends.
    def phase_tiles(a: int, gi: Tuple[int, int, int], layer: int) -> np.ndarray:
        sel = tiles[:, a] == layer
        for b in range(3):
            if b == a:
                continue
            if grid[b] == 1:
                continue
            sel &= ext_sel(b, gi[b]) if b < a else own_sel(b, gi[b])
        t = tiles[sel]
        return t[np.argsort(C.pack_keys_np(t))]

    exchange: List[jax.Array] = []
    perms: List[Tuple[tuple, tuple]] = []
    stride = {0: Dy * Dz, 1: Dz, 2: 1}
    for a in range(3):
        if grid[a] == 1:
            continue
        fwd, bwd = [], []
        sends_hi: List[Tuple[int, np.ndarray]] = []
        sends_lo: List[Tuple[int, np.ndarray]] = []
        recvs_lo: List[Tuple[int, np.ndarray]] = []
        recvs_hi: List[Tuple[int, np.ndarray]] = []
        for ix in range(Dx):
            for iy in range(Dy):
                for iz in range(Dz):
                    gi = (ix, iy, iz)
                    d = dev(*gi)
                    i = gi[a]
                    if i < grid[a] - 1:
                        fwd.append((d, d + stride[a]))
                        sends_hi.append((d, phase_tiles(a, gi, bounds[a][i][1])))
                    if i > 0:
                        bwd.append((d, d - stride[a]))
                        sends_lo.append((d, phase_tiles(a, gi, bounds[a][i][0])))
                        recvs_lo.append((d, phase_tiles(a, gi, bounds[a][i - 1][1])))
                    if i < grid[a] - 1:
                        recvs_hi.append((d, phase_tiles(a, gi, bounds[a][i + 1][0])))
        G = max(
            [len(t) for _, t in sends_hi + sends_lo] + [1]
        )
        send_lo = np.zeros((D, G), np.int32)
        send_hi = np.zeros((D, G), np.int32)
        recv_lo = np.full((D, G), trash, np.int32)
        recv_hi = np.full((D, G), trash, np.int32)
        for arr, entries in (
            (send_hi, sends_hi), (send_lo, sends_lo),
            (recv_lo, recvs_lo), (recv_hi, recvs_hi),
        ):
            for d, t in entries:
                for j, kk in enumerate(C.pack_keys_np(t)):
                    arr[d, j] = row_of[d][int(kk)]
        exchange += [jnp.asarray(send_lo), jnp.asarray(send_hi),
                     jnp.asarray(recv_lo), jnp.asarray(recv_hi)]
        perms.append((tuple(fwd), tuple(bwd)))

    return BoxTopology(
        keys=jnp.asarray(keys),
        origins=jnp.asarray(origins),
        nbr=jnp.asarray(nbr),
        n_rows=jnp.asarray(n_rows),
        local_mask=jnp.asarray(local_mask),
        exchange=tuple(exchange),
        perms=tuple(perms),
        grid=grid,
    )

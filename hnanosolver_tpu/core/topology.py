"""Sparse tile topology: the flat-array analog of NanoVDB's ValueOnIndex grid.

The reference builds a NanoVDB index tree on the GPU every frame
(`/root/reference/src/Cuda/HNanoSolver.cu:375-384`) and walks it with cached
``ReadAccessor``s (`/root/reference/src/Utils/Stencils.hpp:51-93`). Here the
acceleration structure is three flat device arrays with static shapes —
XLA-friendly, rebuilt only when the active set changes:

- ``keys    [T]``      sorted packed tile keys; row 0 = NULL_KEY (the null
                       tile, all-zero values), rows ``[1, n_active]`` active,
                       tail rows = PAD_KEY.
- ``origins [T, 3]``   tile coords (voxel origin = ``origins * 8``); the null
                       and padding rows hold a far-away sentinel.
- ``nbr     [T, 27]``  tile id of each 3x3x3 neighbor (0 where absent), the
                       precomputed analog of the reference's per-kernel tree
                       probes when filling its 10^3 shared-memory halo
                       (`/root/reference/src/Cuda/Kernel.cu:539-548`).

Capacity ``T`` is a static (compile-time) quantity; activating tiles within
capacity never recompiles, growing capacity does — this replaces the
reference's per-cook full topology rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hnanosolver_tpu.core import coords as C

_ORIGIN_SENTINEL = np.int32(1 << 20)  # far outside any valid tile range


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Topology:
    """Static-capacity sparse tile index. A pytree of int32 arrays."""

    keys: jax.Array  # [T] int32, sorted
    origins: jax.Array  # [T, 3] int32 tile coords
    nbr: jax.Array  # [T, 27] int32 tile ids
    n_active: jax.Array  # [] int32: active tile count (rows 1..n_active).
    # n_active is a TRACED scalar, not static aux data: per-frame tile
    # activation within a fixed capacity therefore never recompiles —
    # only capacity growth does (the replacement for the reference's
    # per-cook voxelsToGrid rebuild).

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_voxels(self) -> int:
        """Active voxel count (dense-per-leaf, like the reference's N*512).
        Host-side only (concretizes n_active)."""
        return int(self.n_active) * C.TILE_VOXELS

    def tree_flatten(self):
        return (self.keys, self.origins, self.nbr, self.n_active), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# ---------------------------------------------------------------------------
# Construction (host-side; numpy). A jit-able on-device reactivation path
# lives in `core/activation.py`.
# ---------------------------------------------------------------------------

_NBR_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)  # [27, 3]; index = (dx+1)*9 + (dy+1)*3 + (dz+1); center at 13


def _round_capacity(n: int) -> int:
    """Capacity for n active tiles (+ null row). Power-of-two up to 2048 to
    amortize growth recompiles; beyond that, 25% slack rounded to a multiple
    of 2048 (power-of-two doubling wasted ~2x memory AND compute at large
    tile counts — every op runs over capacity rows)."""
    need = n + 1
    if need <= 2048:
        cap = 16
        while cap < need:
            cap *= 2
        return cap
    return ((int(need * 1.25) + 2047) // 2048) * 2048


def build_topology(
    tile_coords: np.ndarray, capacity: Optional[int] = None
) -> Topology:
    """Build a Topology from an ``[M, 3]`` array of (possibly duplicated)
    tile coordinates. The analog of ``IndexGridBuilder::build`` +
    ``voxelsToGrid`` (`/root/reference/src/Utils/GridBuilder.hpp:221-239`).
    """
    tile_coords = np.asarray(tile_coords, dtype=np.int32).reshape(-1, 3)
    if tile_coords.size:
        lo, hi = tile_coords.min(), tile_coords.max()
        if lo < -C.TILE_OFFSET or hi >= C.TILE_OFFSET:
            raise ValueError(
                f"tile coords out of packable range [-512, 512): [{lo}, {hi}]"
            )
    keys_np = np.unique(C.pack_keys_np(tile_coords))  # sorted unique
    n = int(keys_np.shape[0])
    cap = capacity if capacity is not None else _round_capacity(n)
    if cap < n + 1:
        raise ValueError(f"capacity {cap} < {n + 1} required")

    full_keys = np.full((cap,), C.PAD_KEY, dtype=np.int32)
    full_keys[0] = C.NULL_KEY
    full_keys[1 : n + 1] = keys_np

    origins = np.full((cap, 3), _ORIGIN_SENTINEL, dtype=np.int32)
    if n:
        origins[1 : n + 1] = np.stack(
            [
                (keys_np >> 20) & 0x3FF,
                (keys_np >> 10) & 0x3FF,
                keys_np & 0x3FF,
            ],
            axis=-1,
        ).astype(np.int32) - C.TILE_OFFSET

    # Neighbor table via searchsorted on the active key slice.
    nbr = np.zeros((cap, 27), dtype=np.int32)
    if n:
        nbr_tiles = origins[1 : n + 1, None, :] + _NBR_OFFSETS[None, :, :]
        nbr_keys = C.pack_keys_np(nbr_tiles)  # [n, 27]
        pos = np.searchsorted(keys_np, nbr_keys)
        pos_c = np.minimum(pos, n - 1)
        found = keys_np[pos_c] == nbr_keys
        nbr[1 : n + 1] = np.where(found, pos_c + 1, 0).astype(np.int32)

    return Topology(
        keys=jnp.asarray(full_keys),
        origins=jnp.asarray(origins),
        nbr=jnp.asarray(nbr),
        n_active=jnp.asarray(n, jnp.int32),
    )


def build_topology_dense(shape, origin=(0, 0, 0), capacity=None) -> Topology:
    """All tiles active over a dense box of ``shape`` voxels (each a multiple
    of 8), anchored at voxel ``origin``. Used for dense-domain configs and
    for dense-vs-sparse parity tests."""
    shape = tuple(int(s) for s in shape)
    origin = tuple(int(o) for o in origin)
    if any(s % C.LEAF for s in shape) or any(o % C.LEAF for o in origin):
        raise ValueError("shape and origin must be multiples of 8")
    nt = [s // C.LEAF for s in shape]
    ot = [o // C.LEAF for o in origin]
    gx, gy, gz = np.meshgrid(
        np.arange(nt[0]) + ot[0],
        np.arange(nt[1]) + ot[1],
        np.arange(nt[2]) + ot[2],
        indexing="ij",
    )
    tiles = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return build_topology(tiles, capacity=capacity)


def dilate_topology(topo: Topology, radius: int = 1, capacity=None) -> Topology:
    """Activate every tile within Chebyshev ``radius`` of an active tile —
    the analog of the reference's domain dilation
    (`/root/reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:188-199`,
    which dilates by the "padding" param at voxel level; we dilate at tile
    granularity, which is what leaf-dense allocation makes of it anyway)."""
    n = int(topo.n_active)
    active = np.asarray(topo.origins[1 : n + 1])
    offs = np.array(
        [
            (dx, dy, dz)
            for dx in range(-radius, radius + 1)
            for dy in range(-radius, radius + 1)
            for dz in range(-radius, radius + 1)
        ],
        dtype=np.int32,
    )
    grown = (active[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    return build_topology(grown, capacity=capacity)


# ---------------------------------------------------------------------------
# Lookup (device-side, jit-friendly)
# ---------------------------------------------------------------------------


def lookup_tiles(topo: Topology, tile_coords) -> jax.Array:
    """Tile coords ``[..., 3]`` -> tile ids (0 where inactive).

    Vectorized binary search over the sorted key table — the replacement for
    the reference's per-thread NanoVDB tree probe
    (`/root/reference/src/Utils/Stencils.hpp:53-66`)."""
    tc = jnp.asarray(tile_coords)
    shifted = tc + C.TILE_OFFSET
    # Out-of-range coords (e.g. padding-tile sentinel origins) would overflow
    # the 10-bit key fields and could alias a valid key; reject them first.
    in_range = jnp.all((shifted >= 0) & (shifted < 2 * C.TILE_OFFSET), axis=-1)
    q = C.pack_keys(tc)
    pos = jnp.searchsorted(topo.keys, q).astype(jnp.int32)
    pos = jnp.minimum(pos, topo.capacity - 1)
    found = (topo.keys[pos] == q) & in_range
    return jnp.where(found, pos, 0)


def lookup_voxels(topo: Topology, voxel_coords) -> jax.Array:
    """Voxel coords ``[..., 3]`` -> flat index into ``values.reshape(T*512)``.

    Inactive voxels map into the null tile (rows [0, 512)), which holds
    zeros — the reference's "offset 0 => background" convention
    (`/root/reference/src/Utils/Stencils.hpp:81-89`), minus its buggy
    variant that reads voxel 0 instead (documented deviation, SURVEY §7.5)."""
    vc = jnp.asarray(voxel_coords)
    tile = lookup_tiles(topo, C.voxel_to_tile(vc))
    local = C.local_flat_index(C.voxel_to_local(vc))
    return tile * C.TILE_VOXELS + jnp.where(tile > 0, local, 0)


def voxel_positions(topo: Topology) -> jax.Array:
    """World-index-space voxel coordinates ``[T, 8, 8, 8, 3]`` (int32)."""
    L = C.LEAF
    lx = jax.lax.broadcasted_iota(jnp.int32, (L, L, L), 0)
    ly = jax.lax.broadcasted_iota(jnp.int32, (L, L, L), 1)
    lz = jax.lax.broadcasted_iota(jnp.int32, (L, L, L), 2)
    local = jnp.stack([lx, ly, lz], axis=-1)  # [8,8,8,3]
    return topo.origins[:, None, None, None, :] * C.LEAF + local[None]


def active_mask(topo: Topology) -> jax.Array:
    """[T] float32 mask: 1.0 for active tile rows, 0.0 for null/padding."""
    ids = jax.lax.broadcasted_iota(jnp.int32, (topo.capacity, 1), 0)[:, 0]
    return ((ids >= 1) & (ids <= topo.n_active)).astype(jnp.float32)

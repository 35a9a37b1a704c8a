"""Tile-coordinate packing and voxel <-> tile index math.

The reference solver addresses voxels through a NanoVDB ``ValueOnIndex`` grid:
coord -> 1-based linear offset, 0 = inactive/background
(`/root/reference/src/Utils/Stencils.hpp:51-93`). We replace the tree with a
*sorted packed-key table*: each active 8^3 leaf tile's coordinate is packed
into one int32 key; lookups are vectorized binary searches
(``jnp.searchsorted``), which vectorize and are fully
deterministic (no hash collisions, no per-frame GPU tree build like the
reference's ``voxelsToGrid``, `/root/reference/src/Cuda/HNanoSolver.cu:375-384`).

Conventions
-----------
- ``LEAF = 8``: tile edge length in voxels (matches NanoVDB leaf nodes).
- Tile coordinates ``t = voxel >> 3`` live in ``[-TILE_OFFSET, TILE_OFFSET)``
  per axis (1024 tiles = 8192 voxels of extent — covers the 1024^3 target).
- Packed key: ``((tx+512) << 20) | ((ty+512) << 10) | (tz+512)`` — a
  nonneg int32 < 2^30. Packing is monotone per axis, x-major, so sorted key
  order equals lexicographic (x, y, z) tile order.
- Key sentinels: ``NULL_KEY`` (int32 min) sorts before every valid key and
  marks table row 0, the *null tile* whose field values are identically
  zero (the analog of the reference's "offset 0 => background 0" rule).
  ``PAD_KEY`` (2^30) sorts after every valid key and marks padding rows.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LEAF = 8  # voxels per tile edge
TILE_VOXELS = LEAF * LEAF * LEAF  # 512
TILE_OFFSET = 512  # tile coords valid in [-512, 512)
_SHIFT_X = 20
_SHIFT_Y = 10

NULL_KEY = np.int32(np.iinfo(np.int32).min)  # row 0: the null (background) tile
PAD_KEY = np.int32(1 << 30)  # inactive padding rows at the table tail


def pack_keys(tile_coords):
    """Pack int tile coordinates ``[..., 3]`` into sortable int32 keys."""
    t = tile_coords
    x = t[..., 0] + TILE_OFFSET
    y = t[..., 1] + TILE_OFFSET
    z = t[..., 2] + TILE_OFFSET
    return (
        (x.astype(jnp.int32) << _SHIFT_X)
        | (y.astype(jnp.int32) << _SHIFT_Y)
        | z.astype(jnp.int32)
    )


def unpack_keys(keys):
    """Inverse of :func:`pack_keys` -> int32 tile coords ``[..., 3]``."""
    k = keys
    x = (k >> _SHIFT_X) & 0x3FF
    y = (k >> _SHIFT_Y) & 0x3FF
    z = k & 0x3FF
    return jnp.stack(
        [x - TILE_OFFSET, y - TILE_OFFSET, z - TILE_OFFSET], axis=-1
    ).astype(jnp.int32)


def pack_keys_np(tile_coords: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`pack_keys` for host-side topology builds."""
    t = np.asarray(tile_coords, dtype=np.int64)
    key = (
        ((t[..., 0] + TILE_OFFSET) << _SHIFT_X)
        | ((t[..., 1] + TILE_OFFSET) << _SHIFT_Y)
        | (t[..., 2] + TILE_OFFSET)
    )
    return key.astype(np.int32)


def voxel_to_tile(voxel_coords):
    """Voxel coord -> owning tile coord (arithmetic shift handles negatives)."""
    return voxel_coords >> 3


def voxel_to_local(voxel_coords):
    """Voxel coord -> offset within its tile, each component in [0, 8)."""
    return voxel_coords & 7


def local_flat_index(local):
    """(lx, ly, lz) in-tile offsets -> flat index in [0, 512), x-major."""
    return (local[..., 0] * LEAF + local[..., 1]) * LEAF + local[..., 2]

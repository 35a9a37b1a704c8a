"""Canonical field layouts and flat<->block conversion.

Every hot op works on one contiguous 512-element row per 8^3 tile, so a
tile is one row gather and its neighbours are index arithmetic within the
row. The canonical layouts are:

- scalar field:   ``[T, 512]``      (x-major in-tile order
                                     col = x*64 + y*8 + z)
- velocity:       ``[3, T, 512]``   (channel-major: ops touch components
                                     separately anyway)

Block views ``[T,8,8,8]`` / ``[T,8,8,8,3]`` exist only at API boundaries
(I/O, tests, conversion) via the helpers here.

In-tile neighbor access in flat layout is a roll along the row; see
``ops/stencil.py`` / ``ops/pressure.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TILE = 512

# static per-column coordinate decompositions (col = x*64 + y*8 + z)
COL = jax.lax.broadcasted_iota(jnp.int32, (1, TILE), 1)
CX = COL // 64
CY = (COL // 8) % 8
CZ = COL % 8


def scalar_to_blocks(f: jax.Array) -> jax.Array:
    """[T,512] -> [T,8,8,8] (layout copy; boundary use only)."""
    return f.reshape(f.shape[0], 8, 8, 8)


def scalar_from_blocks(f: jax.Array) -> jax.Array:
    """[T,8,8,8] -> [T,512]."""
    return f.reshape(f.shape[0], TILE)


def vec_to_blocks(v: jax.Array) -> jax.Array:
    """[3,T,512] -> [T,8,8,8,3]."""
    return jnp.moveaxis(v, 0, -1).reshape(v.shape[1], 8, 8, 8, 3)


def vec_from_blocks(v: jax.Array) -> jax.Array:
    """[T,8,8,8,3] -> [3,T,512]."""
    return jnp.moveaxis(v.reshape(v.shape[0], TILE, 3), -1, 0)


def positions_flat(topo) -> tuple[jax.Array, jax.Array, jax.Array]:
    """World voxel coordinates as three [T,512] int32 arrays."""
    org = topo.origins * 8  # [T,3]
    return (
        org[:, 0:1] + CX,
        org[:, 1:2] + CY,
        org[:, 2:3] + CZ,
    )


def parity_flat(topo) -> jax.Array:
    """(i+j+k) & 1 per column, [T,512] int32."""
    org = topo.origins * 8
    base = (org[:, 0] + org[:, 1] + org[:, 2])[:, None]
    return (base + CX + CY + CZ) & 1

"""Halo assembly: gather 1-voxel shells from the 26 neighbor tiles.

The flat-layout equivalent of the reference's shared-memory 10^3 halo load
(`/root/reference/src/Cuda/Kernel.cu:539-548,714-722`): instead of per-thread
tree probes into NanoVDB, each offset direction performs ONE vectorized
gather of pre-sliced neighbor planes/edges/corners via the precomputed
``Topology.nbr`` table. Missing neighbors resolve to tile 0 (the null tile),
whose values are identically zero — background semantics for free.

All gathers are row-gathers over the leading (tile) axis; read volume is
proportional to the shell actually needed (faces 64 voxels, edges 8, corners 1), not whole tiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hnanosolver_tpu.core.topology import Topology

# slice selectors per axis offset: source slice in the neighbor tile and
# destination slice in the padded tile.
#   offset -1: neighbor below provides its top plane (idx 7) -> pad idx 0
#   offset  0: own full extent (0..8) -> pad 1..9
#   offset +1: neighbor above provides its bottom plane (idx 0) -> pad idx 9
def _src(o: int, r: int) -> slice:
    """Source slice in the neighbor tile for axis offset o and halo radius r."""
    return {-1: slice(8 - r, 8), 0: slice(0, 8), 1: slice(0, r)}[o]


def _dst(o: int, r: int) -> slice:
    """Destination slice in the padded tile."""
    return {-1: slice(0, r), 0: slice(r, r + 8), 1: slice(r + 8, r + 8 + r)}[o]


def gather_halo(
    topo: Topology, field: jax.Array, radius: int = 1, faces_only: bool = False
) -> jax.Array:
    """[T, 8, 8, 8, *ch] -> [T, 8+2r, 8+2r, 8+2r, *ch] with an r-voxel halo
    from the neighbor tiles (r <= 8: everything needed lives in the
    27-neighborhood). All data movement is contiguous row gathers over the
    tile axis; no per-element gathers.

    ``faces_only`` gathers just the 6 face neighbors — enough for every
    7-point stencil (pressure Laplacian, divergence, gradient, curl), at a
    quarter of the gather count; edge/corner halo cells stay zero and must
    not be read."""
    r = radius
    assert 1 <= r <= 8
    T = field.shape[0]
    ch = field.shape[4:]
    E = 8 + 2 * r
    pad = jnp.zeros((T, E, E, E) + ch, field.dtype)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nz = (ox != 0) + (oy != 0) + (oz != 0)
                if faces_only and nz > 1:
                    continue
                sub = field[:, _src(ox, r), _src(oy, r), _src(oz, r)]
                if nz == 0:
                    vals = sub
                else:
                    d = (ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)
                    vals = jnp.take(sub, topo.nbr[:, d], axis=0)
                pad = pad.at[:, _dst(ox, r), _dst(oy, r), _dst(oz, r)].set(vals)
    return pad


def face_shift_views(topo: Topology, field: jax.Array):
    """The six +-1 face-shifted views of a field WITHOUT materializing a
    padded buffer: each view = concat(in-tile slice, gathered neighbor face
    plane). XLA fuses the concats into the consuming elementwise op, so a
    7-point stencil costs 6 small row-gathers (~1/4 tile each) plus one fused
    loop.

    Returns a dict {(dx,dy,dz): view} with views shaped like ``field``.
    """
    nbr = topo.nbr

    def take_face(sub, d):
        return jnp.take(sub, nbr[:, d], axis=0)

    d_of = lambda ox, oy, oz: (ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)
    out = {}
    # +x: shift(+1,0,0)[i] = field[i+1]; i=7 comes from +x neighbor's x=0 plane
    out[(1, 0, 0)] = jnp.concatenate(
        [field[:, 1:8], take_face(field[:, 0:1], d_of(1, 0, 0))], axis=1
    )
    out[(-1, 0, 0)] = jnp.concatenate(
        [take_face(field[:, 7:8], d_of(-1, 0, 0)), field[:, 0:7]], axis=1
    )
    out[(0, 1, 0)] = jnp.concatenate(
        [field[:, :, 1:8], take_face(field[:, :, 0:1], d_of(0, 1, 0))], axis=2
    )
    out[(0, -1, 0)] = jnp.concatenate(
        [take_face(field[:, :, 7:8], d_of(0, -1, 0)), field[:, :, 0:7]], axis=2
    )
    out[(0, 0, 1)] = jnp.concatenate(
        [field[:, :, :, 1:8], take_face(field[:, :, :, 0:1], d_of(0, 0, 1))],
        axis=3,
    )
    out[(0, 0, -1)] = jnp.concatenate(
        [take_face(field[:, :, :, 7:8], d_of(0, 0, -1)), field[:, :, :, 0:7]],
        axis=3,
    )
    return out


def center(pad: jax.Array) -> jax.Array:
    """The un-padded 8^3 interior of a halo array (any radius)."""
    r = (pad.shape[1] - 8) // 2
    return pad[:, r : r + 8, r : r + 8, r : r + 8]


def shift(pad: jax.Array, dx: int, dy: int, dz: int) -> jax.Array:
    """Neighbor view at integer offset (dx,dy,dz), each within the halo
    radius: ``shift(pad, 1, 0, 0)[t, i, j, k] == field[t-site + (1,0,0)]``."""
    r = (pad.shape[1] - 8) // 2
    return pad[
        :, r + dx : r + 8 + dx, r + dy : r + 8 + dy, r + dz : r + 8 + dz
    ]

"""Sparse field samplers: nearest and trilinear at arbitrary positions.

Functional re-design of the reference's device samplers
(`/root/reference/src/Utils/Stencils.hpp:20-173`):

- ``IndexSampler<T,0>`` (nearest)    -> :func:`sample_nearest`
- ``IndexSampler<T,1>``/``TrilinearSampler`` -> :func:`sample_trilinear`

Inactive voxels read as exact background 0 via the null tile. Note the
reference's *manual* interpolation paths clamp a missing offset to array
index 0 — i.e. they read voxel 0's value instead of background
(`/root/reference/src/Cuda/Kernel.cu:132-133,191-192`); we implement the
correct background convention everywhere (documented deviation, SURVEY §7.5).

Positions are in index space (voxel units), matching the reference's
``coord.asVec3s()`` convention where voxel centers sit at integer positions.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from hnanosolver_tpu.core import coords as C
from hnanosolver_tpu.core.topology import Topology, lookup_voxels


def _flat(field: jax.Array) -> jax.Array:
    """[T,8,8,8,*ch] -> [T*512, *ch]."""
    T = field.shape[0]
    return field.reshape((T * C.TILE_VOXELS,) + field.shape[4:])


def sample_nearest(topo: Topology, field: jax.Array, voxel_coords) -> jax.Array:
    """Integer-coordinate read; background 0 outside the active set."""
    idx = lookup_voxels(topo, voxel_coords)
    return jnp.take(_flat(field), idx, axis=0)


def sample_trilinear(topo: Topology, field: jax.Array, pos) -> jax.Array:
    """Trilinear interpolation at float positions ``[..., 3]``.

    8-corner gather with fused weight products, mirroring the math of
    `/root/reference/src/Utils/Stencils.hpp:95-164` (lerp ordering) and the
    manual path in `/root/reference/src/Cuda/Kernel.cu:163-196` (weight
    products w00*itz etc.), with true zero background at inactive corners.
    """
    pos = jnp.asarray(pos)
    base = jnp.floor(pos)
    frac = pos - base
    base = base.astype(jnp.int32)

    tx, ty, tz = frac[..., 0], frac[..., 1], frac[..., 2]
    itx, ity, itz = 1.0 - tx, 1.0 - ty, 1.0 - tz
    w00, w10 = itx * ity, tx * ity
    w01, w11 = itx * ty, tx * ty
    weights = (
        w00 * itz,  # (0,0,0)
        w10 * itz,  # (1,0,0)
        w01 * itz,  # (0,1,0)
        w11 * itz,  # (1,1,0)
        w00 * tz,  # (0,0,1)
        w10 * tz,  # (1,0,1)
        w01 * tz,  # (0,1,1)
        w11 * tz,  # (1,1,1)
    )
    corners = (
        (0, 0, 0),
        (1, 0, 0),
        (0, 1, 0),
        (1, 1, 0),
        (0, 0, 1),
        (1, 0, 1),
        (0, 1, 1),
        (1, 1, 1),
    )
    flat = _flat(field)
    vector = field.ndim == 5
    acc = None
    for (di, dj, dk), w in zip(corners, weights):
        coord = base + jnp.array([di, dj, dk], dtype=jnp.int32)
        idx = lookup_voxels(topo, coord)
        v = jnp.take(flat, idx, axis=0)
        if vector:
            v = v * w[..., None]
        else:
            v = v * w
        acc = v if acc is None else acc + v
    return acc


# ---------------------------------------------------------------------------
# Local (halo-block) samplers.
#
# The global samplers above go through a sorted-key binary search plus flat
# element gathers per corner. The local samplers instead assemble an r-voxel
# halo block per tile with contiguous row gathers (ops/halo.py) and read
# interpolation corners with batched in-row gathers
# (``jnp.take_along_axis`` over the flattened per-tile block). The price: sample displacements are clamped to the halo
# radius (a CFL-style clamp the reference does not apply — documented
# deviation; radius is configurable per op).
# ---------------------------------------------------------------------------


def displacement_limit(radius: int) -> float:
    """Max representable displacement magnitude per axis for a halo radius
    (one voxel is reserved for the +1 interpolation corner)."""
    return float(radius) - 1.0 - 1e-3


def _clamp_disp(disp: jax.Array, radius: int) -> jax.Array:
    lim = displacement_limit(radius)
    return jnp.clip(disp, -lim, lim)


def _corner_flat_idx(base, E):
    """Flatten in-block int coords [T,8,8,8,3] -> [T, 512] block indices."""
    T = base.shape[0]
    idx = (base[..., 0] * E + base[..., 1]) * E + base[..., 2]
    return idx.reshape(T, 512)


def _block_gather(block_flat: jax.Array, idx: jax.Array) -> jax.Array:
    """block_flat [T, E^3(,ch)], idx [T,512] -> [T,8,8,8(,ch)]."""
    T = block_flat.shape[0]
    if block_flat.ndim == 2:
        out = jnp.take_along_axis(block_flat, idx, axis=1)
        return out.reshape(T, 8, 8, 8)
    ch = block_flat.shape[2]
    outs = [
        jnp.take_along_axis(block_flat[:, :, c], idx, axis=1) for c in range(ch)
    ]
    return jnp.stack(outs, axis=-1).reshape(T, 8, 8, 8, ch)


def sample_trilinear_local(
    topo: Topology,
    field: jax.Array,
    disp: jax.Array,
    radius: int = 4,
    block: Optional[jax.Array] = None,
) -> jax.Array:
    """Trilinear sample at (voxel position + disp) for every active voxel.

    ``disp`` is the float displacement [T,8,8,8,3] from each voxel's own
    position, clamped to the halo radius. Pass a precomputed ``block``
    (= gather_halo(topo, field, radius)) to share halos across calls.
    """
    from hnanosolver_tpu.ops.halo import gather_halo

    E = 8 + 2 * radius
    if block is None:
        block = gather_halo(topo, field, radius)
    T = field.shape[0]
    vector = field.ndim == 5
    block_flat = block.reshape((T, E * E * E) + ((field.shape[-1],) if vector else ()))

    disp = _clamp_disp(disp, radius)
    # local position of the sample inside the halo block
    lx = jax.lax.broadcasted_iota(jnp.float32, (8, 8, 8), 0)
    ly = jax.lax.broadcasted_iota(jnp.float32, (8, 8, 8), 1)
    lz = jax.lax.broadcasted_iota(jnp.float32, (8, 8, 8), 2)
    local = jnp.stack([lx, ly, lz], axis=-1)[None] + float(radius) + disp
    base = jnp.floor(local)
    frac = local - base
    base = base.astype(jnp.int32)
    base = jnp.clip(base, 0, E - 2)

    tx, ty, tz = frac[..., 0], frac[..., 1], frac[..., 2]
    itx, ity, itz = 1.0 - tx, 1.0 - ty, 1.0 - tz
    w = {
        (0, 0, 0): itx * ity * itz,
        (1, 0, 0): tx * ity * itz,
        (0, 1, 0): itx * ty * itz,
        (1, 1, 0): tx * ty * itz,
        (0, 0, 1): itx * ity * tz,
        (1, 0, 1): tx * ity * tz,
        (0, 1, 1): itx * ty * tz,
        (1, 1, 1): tx * ty * tz,
    }
    acc = None
    for (di, dj, dk), wt in w.items():
        idx = _corner_flat_idx(base + jnp.array([di, dj, dk], jnp.int32), E)
        v = _block_gather(block_flat, idx)
        v = v * (wt[..., None] if vector else wt)
        acc = v if acc is None else acc + v
    return acc


def sample_offset_local(
    topo: Topology, field: jax.Array, offset, radius: Optional[int] = None,
    block: Optional[jax.Array] = None,
) -> jax.Array:
    """Integer-offset neighbor read for every voxel (nearest semantics):
    ``out[t,i,j,k] = field[(t,i,j,k) + offset]`` with background 0. A
    shift view over a radius-|offset| halo — zero gathers beyond the halo
    assembly."""
    from hnanosolver_tpu.ops.halo import gather_halo, shift

    off = tuple(int(o) for o in offset)
    r = radius if radius is not None else max(1, max(abs(o) for o in off))
    if block is None:
        block = gather_halo(topo, field, r)
    return shift(block, *off)

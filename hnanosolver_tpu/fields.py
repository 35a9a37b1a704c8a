"""FieldState — the named-field container (GridIndexedData analog).

The reference stores one coord array plus N named SoA value blocks
(`/root/reference/src/Utils/GridData.hpp:16-166`), dense per 8^3 leaf
(``totalVoxels = numLeaves * 512``). Here fields live in the canonical
flat layout (core/layout.py):

- scalar fields: ``[T, 512]`` float32 (x-major in-tile order),
- velocity:      ``[3, T, 512]`` float32 (channel-major),

where ``T`` is the topology capacity; row 0 (null tile) and padding rows are
kept identically zero — an invariant every sampler relies on. Block views
``[T,8,8,8]`` / ``[T,8,8,8,3]`` are available at API boundaries via
``scalar_blocks`` / ``velocity_blocks``.

FieldState is a pytree, so it passes through jit/shard_map/scan unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from hnanosolver_tpu.core import layout as L
from hnanosolver_tpu.core.topology import Topology, active_mask

COMBUSTION_FIELDS = ("fuel", "waste", "temperature", "flame")
COLLISION_FIELD = "collision_sdf"


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FieldState:
    """velocity [3,T,512] + named scalar fields [T,512]."""

    velocity: jax.Array
    scalars: Dict[str, jax.Array]

    def tree_flatten(self):
        names = tuple(sorted(self.scalars))
        return (self.velocity, tuple(self.scalars[n] for n in names)), names

    @classmethod
    def tree_unflatten(cls, names, children):
        velocity, vals = children
        return cls(velocity=velocity, scalars=dict(zip(names, vals)))

    # -- convenience ------------------------------------------------------
    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)

    def with_scalar(self, name: str, value: jax.Array) -> "FieldState":
        s = dict(self.scalars)
        s[name] = value
        return self.replace(scalars=s)

    @property
    def capacity(self) -> int:
        return self.velocity.shape[1]

    def sdf(self) -> Optional[jax.Array]:
        return self.scalars.get(COLLISION_FIELD)

    # -- block-layout views (API boundaries: I/O, tests, conversion) -------
    def scalar_blocks(self, name: str) -> jax.Array:
        return L.scalar_to_blocks(self.scalars[name])

    def velocity_blocks(self) -> jax.Array:
        return L.vec_to_blocks(self.velocity)

    @classmethod
    def from_blocks(cls, velocity_blocks, scalar_blocks: Dict[str, jax.Array]):
        return cls(
            velocity=L.vec_from_blocks(jnp.asarray(velocity_blocks)),
            scalars={
                k: L.scalar_from_blocks(jnp.asarray(v))
                for k, v in scalar_blocks.items()
            },
        )


def zeros_state(
    topo: Topology,
    scalar_names=("density", "temperature", "fuel", "waste", "flame"),
    dtype=jnp.float32,
) -> FieldState:
    """Zero-initialized state matching a topology. The reference requires the
    four combustion fields to exist even for pure smoke
    (`/root/reference/src/Cuda/HNanoSolver.cu:193-201`); we keep the same
    contract for the full step."""
    T = topo.capacity
    return FieldState(
        velocity=jnp.zeros((3, T, L.TILE), dtype),
        scalars={n: jnp.zeros((T, L.TILE), dtype) for n in scalar_names},
    )


def mask_state(topo: Topology, state: FieldState) -> FieldState:
    """Zero out null/padding tile rows, restoring the background invariant."""
    m = active_mask(topo)[:, None]  # [T,1]
    return FieldState(
        velocity=state.velocity * m[None],
        scalars={k: v * m for k, v in state.scalars.items()},
    )


def source_into(state: FieldState, source: FieldState) -> FieldState:
    """Composite a sourcing state additively — the analog of the reference's
    ``openvdb::tools::compSum`` sourcing path
    (`/root/reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:161-181`)."""
    scalars = dict(state.scalars)
    for k, v in source.scalars.items():
        if k == COLLISION_FIELD:
            scalars[k] = v  # SDF is replaced, not summed
        else:
            scalars[k] = scalars.get(k, jnp.zeros_like(v)) + v
    return FieldState(velocity=state.velocity + source.velocity, scalars=scalars)

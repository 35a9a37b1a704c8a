"""Multi-device scaling: tile-axis sharding over a JAX device mesh.

The reference is single-GPU with no distributed backend (SURVEY §2.7/§5.8);
scaling here is designed for a device mesh instead of ported:

- Fields ``[T, 8, 8, 8, ...]`` are sharded on the leading tile axis over the
  ``"x"`` mesh axis. Packed tile keys sort x-major (core/coords.py), so
  contiguous row ranges ARE spatial slabs along x — the shard boundary is a
  plane, and cross-shard neighbor traffic is the slab face only.
- The topology tables (keys/origins/nbr — a few MB even at 1024^3) are
  replicated; XLA then partitions every elementwise/stencil op and inserts
  the collectives for the halo row-gathers under ``jit`` (GSPMD). A
  shard_map + ``ppermute`` explicit-ghost path is the planned optimization
  once profiling justifies it (SURVEY §7.2 phase 5).

Capacities are powers of two, so the tile axis always divides the mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hnanosolver_tpu.config import SolverParams
from hnanosolver_tpu.core.topology import Topology
from hnanosolver_tpu.fields import FieldState
from hnanosolver_tpu.models.plume import PlumeConfig, emit
from hnanosolver_tpu.solver import step


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def field_sharding(mesh: Mesh, axis: str = "x") -> NamedSharding:
    """Tile-axis (slab) sharding for a [T, ...] field array."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_topology(mesh: Mesh, topo: Topology) -> Topology:
    r = replicated(mesh)
    return Topology(
        keys=jax.device_put(topo.keys, r),
        origins=jax.device_put(topo.origins, r),
        nbr=jax.device_put(topo.nbr, r),
        n_active=jax.device_put(topo.n_active, r),
    )


def vel_sharding(mesh: Mesh, axis: str = "x") -> NamedSharding:
    """Velocity is channel-major [3,T,512]: shard the tile axis (dim 1)."""
    return NamedSharding(mesh, P(None, axis))


def shard_state(mesh: Mesh, state: FieldState, axis: str = "x") -> FieldState:
    fs = field_sharding(mesh, axis)
    return FieldState(
        velocity=jax.device_put(state.velocity, vel_sharding(mesh, axis)),
        scalars={k: jax.device_put(v, fs) for k, v in state.scalars.items()},
    )


def make_sharded_step(mesh: Mesh, params: SolverParams, cfg: Optional[PlumeConfig] = None, axis: str = "x"):
    """jit-compiled full step with slab shardings pinned on inputs/outputs.
    With ``cfg`` the emitter runs first (the flagship training-step shape)."""
    fs = field_sharding(mesh, axis)

    def state_shardings(state: FieldState) -> FieldState:
        return FieldState(
            velocity=vel_sharding(mesh, axis),
            scalars={k: fs for k in state.scalars},
        )

    def fn(topo: Topology, state: FieldState) -> FieldState:
        if cfg is not None:
            state = emit(topo, state, cfg, params.dt)
        return step(topo, state, params)

    def run(topo: Topology, state: FieldState) -> FieldState:
        out_shardings = state_shardings(state)
        return jax.jit(fn, out_shardings=out_shardings)(topo, state)

    return run

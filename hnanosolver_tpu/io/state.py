"""Checkpoint / resume: serialize (Topology, FieldState, frame metadata).

The reference has no in-process persistence — frame state round-trips
through Houdini's geometry stream and .bgeo caches (SURVEY §5.4,
`/root/reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:106-114`). Here the
"state is the fields" model is kept, serialized to a single ``.npz`` per
checkpoint: topology tables + every field + params metadata. Loads are exact
(bit-for-bit fields), so a resumed run continues deterministically.

Two formats:
- ``save_npz`` / ``load_npz``: one self-contained file, no extra deps.
- ``save_sparse_npz``: coordinate-list interchange (coords + per-field
  values of ACTIVE voxels only) — the compact export format, convertible to
  OpenVDB offline; uses the native tile builder for encode/decode.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from hnanosolver_tpu.config import CombustionParams, SolverParams
from hnanosolver_tpu.core.topology import Topology, build_topology
from hnanosolver_tpu.fields import FieldState

_FORMAT_VERSION = 2  # v2: flat layout (scalars [T,512], velocity [3,T,512])


def save_npz(path: str, topo: Topology, state: FieldState,
             params: Optional[SolverParams] = None, frame: int = 0) -> None:
    meta = {
        "version": _FORMAT_VERSION,
        "frame": frame,
        "n_active": int(topo.n_active),
        "scalar_names": sorted(state.scalars),
        "params": dataclasses.asdict(params) if params else None,
    }
    arrays = {
        "keys": np.asarray(topo.keys),
        "origins": np.asarray(topo.origins),
        "nbr": np.asarray(topo.nbr),
        "velocity": np.asarray(state.velocity),
    }
    for k, v in state.scalars.items():
        arrays[f"scalar_{k}"] = np.asarray(v)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_npz(path: str) -> Tuple[Topology, FieldState, Optional[SolverParams], int]:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        topo = Topology(
            keys=jnp.asarray(z["keys"]),
            origins=jnp.asarray(z["origins"]),
            nbr=jnp.asarray(z["nbr"]),
            n_active=jnp.asarray(meta["n_active"], jnp.int32),
        )
        state = FieldState(
            velocity=jnp.asarray(z["velocity"]),
            scalars={
                k: jnp.asarray(z[f"scalar_{k}"]) for k in meta["scalar_names"]
            },
        )
        params = None
        if meta["params"]:
            # keys of retired options (older checkpoints) are dropped
            known = {f.name for f in dataclasses.fields(SolverParams)}
            p = {k: v for k, v in meta["params"].items() if k in known}
            p["combustion"] = CombustionParams(**p["combustion"])
            params = SolverParams(**p)
        return topo, state, params, meta["frame"]


def save_sparse_npz(path: str, topo: Topology, state: FieldState,
                    frame: int = 0) -> None:
    """Coordinate-list export of active voxels only (compact interchange;
    decode path of the native tile builder)."""
    from hnanosolver_tpu.io import native as NT

    n = int(topo.n_active)
    origins = np.asarray(topo.origins)[1 : n + 1]
    coords = NT.tile_coords(origins)  # [n*512, 3]
    arrays = {"coords": coords}
    vel = np.asarray(state.velocity_blocks())[1 : n + 1].reshape(-1, 3)
    arrays["velocity"] = vel
    names = []
    for k, v in state.scalars.items():
        arrays[f"scalar_{k}"] = np.asarray(v)[1 : n + 1].reshape(-1)
        names.append(k)
    meta = {"version": _FORMAT_VERSION, "frame": frame, "scalar_names": sorted(names)}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_sparse_npz(path: str, capacity: Optional[int] = None):
    """Rebuild (Topology, FieldState) from a coordinate-list export."""
    from hnanosolver_tpu.io import native as NT

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        coords = z["coords"]
        keys, origins, row, local = NT.build_index(coords)
        topo = build_topology(origins, capacity=capacity)
        num_rows = topo.capacity
        # NT row ids are 1..M in sorted-key order == topology rows 1..M
        vel_t = NT.scatter(row, local, z["velocity"], num_rows, channels=3)
        state = FieldState.from_blocks(
            vel_t.reshape(num_rows, 8, 8, 8, 3),
            {
                k: NT.scatter(row, local, z[f"scalar_{k}"], num_rows).reshape(
                    num_rows, 8, 8, 8
                )
                for k in meta["scalar_names"]
            },
        )
        return topo, state, meta["frame"]

"""hnanosolver_tpu — a sparse volumetric fluid (smoke/fire) solver in JAX.

Built from scratch in JAX with the capabilities of HNanoSolver
(ZephirFXEC/HNanoSolver, a CUDA/NanoVDB Houdini plugin suite). The NanoVDB
``ValueOnIndex`` acceleration structure of the reference
(`/root/reference/src/Utils/Stencils.hpp:51-93`) is re-designed here as a
block-sparse layout of dense 8^3 leaf tiles plus a sorted coordinate-key
table; all physics runs on-device under ``jax.jit`` (XLA, plus one Pallas
kernel for the pressure sweep on a GPU), and multi-device scaling uses
``shard_map`` over a ``jax.sharding.Mesh`` with ``ppermute`` halo exchange
instead of the reference's single-GPU CUDA streams.

Public API (mirrors the reference's five SOP nodes, see README):
  - ``SolverParams``       — typed config (same names/defaults as the SOP DS file)
  - ``Topology``           — sparse tile index (NanoVDB IndexGrid analog)
  - ``FieldState``         — named field container (GridIndexedData analog)
  - ``step``               — full simulation step (HNanoSolver node)
  - ``advect_scalars``     — standalone scalar advection (HNanoAdvect node)
  - ``advect_velocity``    — standalone velocity self-advection (HNanoAdvectVelocity)
  - ``project``            — pressure projection (HNanoProjectNonDivergent)
  - ``divergence_only``    — raw divergence output (HNanoProjectNonDivergent outdiv)
"""

from hnanosolver_tpu import _compile_cache  # noqa: F401  (sets the cache dir)
from hnanosolver_tpu.config import SolverParams, CombustionParams
from hnanosolver_tpu.core.topology import (
    Topology,
    build_topology,
    build_topology_dense,
    dilate_topology,
)
from hnanosolver_tpu.fields import FieldState
from hnanosolver_tpu.solver import (
    step,
    advect_scalars,
    advect_velocity,
    project,
    divergence_only,
)

__version__ = "0.1.0"

__all__ = [
    "SolverParams",
    "CombustionParams",
    "Topology",
    "build_topology",
    "build_topology_dense",
    "dilate_topology",
    "FieldState",
    "step",
    "advect_scalars",
    "advect_velocity",
    "project",
    "divergence_only",
]

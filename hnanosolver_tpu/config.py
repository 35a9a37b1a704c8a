"""Typed solver configuration.

Parameter names, defaults, and ranges mirror the reference SOP node's DS file
(`/root/reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:21-88`) and the
``CombustionParams`` struct marshaled across its C ABI
(`/root/reference/src/Cuda/Kernels.cuh:6-13`), so parity runs can use
identical settings.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CombustionParams:
    """Physics constants for combustion/buoyancy/vorticity, reference names."""

    expansion_rate: float = 0.1  # SOP "expansion_rate"
    temperature_release: float = 0.5  # SOP "temperature_gain"
    buoyancy_strength: float = 1.0  # SOP "buoyancy_strength"
    ambient_temp: float = 23.0  # SOP "ambient_temp"
    vorticity_scale: float = 1.0  # SOP "vorticity"
    factor_scale: float = 0.5  # SOP "factor_scale"


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Full per-step configuration (SOP parms + CombustionParams).

    All values are static under jit: changing one triggers a recompile, like
    changing a CUDA kernel's launch constants. ``dt`` defaults to 1/24
    (Houdini's ``1/$FPS`` at 24 fps)."""

    # NOTE on voxel_size: the SOR factor omega = 2/(1+sin(pi*dx)) (reference
    # formula) reaches the stability limit omega=2 at dx=1, i.e. the solver
    # assumes sub-unit voxel sizes (Houdini VDBs typically use ~0.1). The
    # default 0.5 yields omega=1 (plain Gauss-Seidel), which always converges.
    dt: float = 1.0 / 24.0
    voxel_size: float = 0.5
    iterations: int = 20  # pressure red-black Gauss-Seidel sweeps
    # pressure solver selection: "rbgs" = the reference's red-black SOR loop;
    # "mg" = multigrid V-cycles (ops/multigrid.py — the reference's declared
    # but never-implemented design). With "mg", ``iterations`` is the number
    # of V-cycles and a hierarchy must be passed to step().
    pressure_solver: str = "rbgs"
    mg_pre: int = 2  # pre-smoothing sweeps per level
    mg_post: int = 2  # post-smoothing sweeps per level
    mg_coarsest: int = 24  # sweeps at the coarsest level
    mg_levels: int = 2  # coarse levels below the fine grid
    # Residual target for "mg": stop cycling once max|r| <= mg_tol * max|div|
    # (``iterations`` caps the cycle count). None = run ``iterations`` cycles.
    mg_tol: float | None = None
    # Full-multigrid (nested-iteration) initial guess before the V-cycles —
    # ~one coarse-side cycle of extra cost replacing 1-2 fine cycles on the
    # global mode (measured 6x residual at equal cost on the tile sphere).
    # Works sharded too: the RHS restriction psums into the replicated
    # coarse levels and the fine-level FMG V-cycle threads the ghost
    # refresh (ops/multigrid.fmg_initial_guess).
    mg_fmg: bool = True
    combustion: CombustionParams = dataclasses.field(default_factory=CombustionParams)
    has_collision: bool = False
    # Documented deviations from the reference (SURVEY §7.5):
    # - inactive reads return true background 0 (null tile) instead of the
    #   reference's occasional clamp-to-voxel-0,
    # - collision_sdf is preserved across steps instead of being zeroed by
    #   the reference's copy-back bug (HNanoSolver.cu:364-369).

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)

    @property
    def inv_voxel_size(self) -> float:
        return 1.0 / self.voxel_size

    @property
    def omega(self) -> float:
        """SOR relaxation factor, 2/(1+sin(pi*dx)) — matches
        `/root/reference/src/Cuda/HNanoSolver.cu:257` (including its
        truncated 3.14159 pi)."""
        import math

        return 2.0 / (1.0 + math.sin(3.14159 * self.voxel_size))

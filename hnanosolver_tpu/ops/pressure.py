"""Pressure solve: red-black Gauss-Seidel with SOR on the 7-point Laplacian.

Matches `/root/reference/src/Cuda/Kernel.cu:591-623` (redBlackGaussSeidelUpdate)
and the host loop `/root/reference/src/Cuda/HNanoSolver.cu:257-269`:

    pGS = (sum_{6 nbrs} p - div * dx^2) / 6
    p  += omega * (pGS - p)      for voxels of the active color

One reference "iteration" = a red sweep then a black sweep. The reference
launches all leaves in parallel with in-place global-memory updates, so its
cross-leaf ordering is chaotic; here each color sweep refreshes the halo
first, giving textbook RBGS — convergence is compared by residual, not by
matching the reference's nondeterministic intermediate states (SURVEY §7.4).

Layout: fields are flat [T,512] (core/layout.py), so one sweep is six
face views (ops/shifts.py) and one fused update pass. On a GPU the
single-device solve runs each colour sweep as one Pallas kernel instead
(ops/rbgs_sweep.py); both give the same update in the same summation order.

Out-of-domain pressure reads are background 0 (Dirichlet p=0 on the sparse
boundary), identical to the reference's index-sampler convention.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hnanosolver_tpu.core.layout import parity_flat
from hnanosolver_tpu.core.topology import Topology
from hnanosolver_tpu.ops.shifts import neighbor_sum


def sweep_impl(platform: str | None = None) -> str:
    """Colour-sweep implementation for ``platform`` (default: JAX's default
    backend, read at trace time): "triton" (ops/rbgs_sweep.py) on a GPU,
    where it beat the XLA sweep end to end, "xla" elsewhere."""
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else "xla"


def _color_sweep(topo, p, div, dx2, omega, color_mask):
    pgs = (neighbor_sum(topo, p) - div * dx2) * (1.0 / 6.0)
    return jnp.where(color_mask, p + omega * (pgs - p), p)


def solve_pressure(
    topo: Topology,
    div: jax.Array,
    iterations: int,
    dx: float,
    omega: float,
    p0: jax.Array | None = None,
    refresh=None,
    mask: jax.Array | None = None,
) -> jax.Array:
    """Run ``iterations`` red+black SOR sweeps from p0 (zeros by default).
    div, p: [T,512]. ``refresh``: ghost-row exchange hook applied to p
    before every color sweep (identity on one device; ppermute under
    shard_map — see parallel/slab.py). ``mask``: in-domain voxel mask
    [T,512]; cells outside stay exactly 0 (Dirichlet) — used by multigrid
    coarse levels whose tiles only partially cover the fine domain."""
    # the kernel serves the single-device solve; a ghost exchange (sharded
    # step) or a coarse-level mask keeps the XLA sweeps
    if refresh is None and mask is None and sweep_impl() == "triton":
        from hnanosolver_tpu.ops import rbgs_sweep

        return rbgs_sweep.solve(topo, div, iterations, dx, omega, p0=p0)
    rf = refresh or (lambda f: f)
    dx2 = dx * dx
    red = parity_flat(topo) == 0
    p = jnp.zeros_like(div) if p0 is None else p0
    if mask is not None:
        p = p * mask
        in_dom = mask > 0
        red_m, black_m = red & in_dom, (~red) & in_dom
    else:
        red_m, black_m = red, ~red

    def body(_, p):
        p = _color_sweep(topo, rf(p), div, dx2, omega, red_m)
        p = _color_sweep(topo, rf(p), div, dx2, omega, black_m)
        return p

    return jax.lax.fori_loop(0, iterations, body, p)


def residual(topo: Topology, p: jax.Array, div: jax.Array, dx: float) -> jax.Array:
    """Pointwise residual r = div - L(p) of the discrete Poisson problem
    L(p) = (sum nbrs - 6 p) / dx^2 (the system the GS update solves)."""
    lap = (neighbor_sum(topo, p) - 6.0 * p) / (dx * dx)
    return div - lap


def jacobi_pressure(
    topo: Topology, div: jax.Array, iterations: int, dx: float, weight: float = 1.0
) -> jax.Array:
    """Weighted-Jacobi variant (fully parallel; smoother for multigrid)."""
    dx2 = dx * dx

    def body(_, p):
        pj = (neighbor_sum(topo, p) - div * dx2) * (1.0 / 6.0)
        return p + weight * (pj - p)

    return jax.lax.fori_loop(0, iterations, body, jnp.zeros_like(div))

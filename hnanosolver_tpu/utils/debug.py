"""Numerical-safety utilities — the functional replacement for the
reference's (absent) race detection / sanitizers (SURVEY §5.2).

CUDA solvers race when block scheduling changes; an XLA program cannot —
the equivalents worth checking are:
- NaN/Inf creation inside the step (``nan_guard`` / ``assert_finite_state``),
- run-to-run bitwise reproducibility (``check_determinism``), the property
  the reference's red-black coloring exists to protect
  (`/root/reference/src/Cuda/Kernel.cu:599-602`),
- background-invariant preservation (null/padding tiles stay zero), which
  every sampler relies on (``check_background_invariant``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnanosolver_tpu.core.topology import Topology, active_mask
from hnanosolver_tpu.fields import FieldState


def nan_guard(tree, where: str = "") -> None:
    """Host-side check (pulls data): raise on any non-finite value."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise FloatingPointError(
                f"{bad} non-finite values in {jax.tree_util.keystr(path)} {where}"
            )


def assert_finite_state(state: FieldState, where: str = "") -> None:
    nan_guard(state, where)


def finite_fraction(state: FieldState) -> Dict[str, float]:
    """Device-side (cheap) diagnostic: fraction of finite entries per field."""
    out = {"velocity": float(jnp.mean(jnp.isfinite(state.velocity)))}
    for k, v in state.scalars.items():
        out[k] = float(jnp.mean(jnp.isfinite(v)))
    return out


def check_background_invariant(topo: Topology, state: FieldState, atol=0.0):
    """Null tile (row 0) and padding rows must hold exact zeros."""
    m = np.asarray(active_mask(topo)) == 0
    for name, arr in [("velocity", state.velocity)] + list(state.scalars.items()):
        a = np.asarray(arr)
        a = np.abs(a[:, m] if name == "velocity" else a[m])  # vel is [3,T,512]
        if a.size and a.max() > atol:
            raise AssertionError(
                f"background invariant violated in {name}: max |v| = {a.max()}"
            )


def check_determinism(step_fn: Callable, *args, runs: int = 2) -> None:
    """Run the jitted step twice on identical inputs and demand bitwise
    identical outputs (the step uses no atomics or run-to-run-varying
    reductions; a mismatch indicates a nondeterministic kernel or a
    donation bug)."""
    ref = None
    for _ in range(runs):
        out = jax.block_until_ready(step_fn(*args))
        flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]
        if ref is None:
            ref = flat
        else:
            for a, b in zip(ref, flat):
                if not np.array_equal(a, b, equal_nan=True):
                    raise AssertionError("step is not bitwise deterministic")


def check_cfl(topo: Topology, state: FieldState, params,
              raise_on_clamp: bool = False) -> int:
    """How many active voxels this step will CFL-clamp (ops/advection
    clips backtrace displacements to <7 voxels; the reference traces
    arbitrarily far, Kernel.cu:139). Returns the count; with
    ``raise_on_clamp`` raises a diagnostic instead — use in debug runs to
    catch dt/velocity combinations that silently diverge from the
    reference. The safe bound is max|u| * dt / dx < 7."""
    from hnanosolver_tpu.ops.advection import cfl_clamped_count

    n = int(cfl_clamped_count(
        topo, state.velocity, params.dt, params.inv_voxel_size
    ))
    if n and raise_on_clamp:
        raise RuntimeError(
            f"CFL clamp engaged on {n} voxels: |u|*dt/dx exceeds 7; reduce "
            f"dt or voxel velocity (reference semantics diverge here)"
        )
    return n

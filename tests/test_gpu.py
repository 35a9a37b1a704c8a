"""Checks that need the GPU. Each takes the ``gpu_device`` fixture, which
skips it where JAX's default device is not a GPU; ``chip_smoke.py`` runs
them on the card (``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_gpu.py`` does the same)."""

import jax
import numpy as np
import pytest

from hnanosolver_tpu.config import SolverParams
from hnanosolver_tpu.core.topology import active_mask, build_topology
from hnanosolver_tpu.ops import pressure as prs
from hnanosolver_tpu.ops import rbgs_sweep as rs

pytestmark = pytest.mark.gpu


def _sparse_case(seed=0):
    rng = np.random.default_rng(seed)
    box = np.array([(x, y, z) for x in range(6) for y in range(5)
                    for z in range(5)])
    topo = build_topology(box[rng.random(len(box)) < 0.6])
    div = rng.standard_normal((topo.capacity, 512)).astype(np.float32)
    return topo, div * np.asarray(active_mask(topo))[:, None]


def test_solve_pressure_takes_the_kernel_on_gpu(gpu_device):
    assert prs.sweep_impl() == "triton"


def test_compiled_sweep_kernel_matches_xla_sweeps(gpu_device,
                                                  monkeypatch):
    topo, div = _sparse_case()
    got = rs.solve(topo, div, 10, 0.5, 1.0)
    monkeypatch.setattr(prs, "sweep_impl", lambda platform=None: "xla")
    want = jax.jit(lambda d: prs.solve_pressure(
        topo, d, 10, 0.5, 1.0))(div)
    scale = float(np.abs(np.asarray(want)).max())
    # same update and summation order; FMA contraction may differ
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)


def test_full_step_matches_dense_oracle_on_gpu(gpu_device, rng):
    """test_parity.py's full-step check, run on the card."""
    import test_parity as tp

    from hnanosolver_tpu.dense.solver import step_dense
    from hnanosolver_tpu.fields import FieldState
    from hnanosolver_tpu.solver import step

    from hnanosolver_tpu.core.topology import build_topology_dense

    topo = build_topology_dense((tp.N, tp.N, tp.N))
    vel_d, rho_d = tp.smooth_fields(rng)
    vel_t = tp.to_flat_vec(topo, vel_d)
    scalars_d = {"density": rho_d, "temperature": 30.0 * rho_d,
                 "fuel": 0.3 * rho_d, "waste": 0.0 * rho_d,
                 "flame": 0.0 * rho_d}
    params = SolverParams(dt=0.2, iterations=6)
    want_v, want_s = step_dense(vel_d, scalars_d, params)
    out = step(topo, FieldState(
        velocity=vel_t,
        scalars={k: tp.to_flat_scalar(topo, v) for k, v in scalars_d.items()},
    ), params)
    for got, want in [(tp.from_flat_vec(topo, out.velocity), want_v)] + [
            (tp.from_flat_scalar(topo, out.scalars[k]), want_s[k])
            for k in scalars_d]:
        scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-4 * scale)

"""Multi-step golden regression: 5 chained full steps sparse-vs-dense stay
within tolerance (catches drift/accumulation bugs the single-step parity
test can't)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hnanosolver_tpu.config import SolverParams
from hnanosolver_tpu.core import layout as L
from hnanosolver_tpu.core.convert import dense_to_tiles, tiles_to_dense
from hnanosolver_tpu.core.topology import build_topology_dense
from hnanosolver_tpu.dense.solver import step_dense
from hnanosolver_tpu.fields import FieldState
from hnanosolver_tpu.solver import step

N = 24


@pytest.mark.slow
def test_five_step_golden(rng):
    x, y, z = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    blob = np.exp(
        -((x - 12) ** 2 + (y - 6) ** 2 + (z - 12) ** 2) / 16.0
    ).astype(np.float32)
    vel_d = jnp.zeros((N, N, N, 3), jnp.float32)
    scalars_d = {
        "density": jnp.asarray(blob),
        "temperature": jnp.asarray(23.0 + 25.0 * blob),
        "fuel": jnp.asarray(0.5 * blob),
        "waste": jnp.zeros((N, N, N)),
        "flame": jnp.zeros((N, N, N)),
    }
    # dt/temps keep trace displacements under the sparse path's 7-voxel
    # CFL clamp (the dense oracle does not clamp — documented deviation)
    params = SolverParams(dt=0.1, iterations=8, voxel_size=0.5)

    topo = build_topology_dense((N, N, N))
    state = FieldState(
        velocity=L.vec_from_blocks(dense_to_tiles(topo, vel_d)),
        scalars={
            k: L.scalar_from_blocks(dense_to_tiles(topo, v))
            for k, v in scalars_d.items()
        },
    )

    for i in range(5):
        vel_d, scalars_d = step_dense(vel_d, scalars_d, params)
        state = step(topo, state, params)

    got_v = tiles_to_dense(topo, L.vec_to_blocks(state.velocity), (N, N, N))
    np.testing.assert_allclose(
        np.asarray(got_v), np.asarray(vel_d), atol=5e-4
    )
    for k in scalars_d:
        got = tiles_to_dense(topo, L.scalar_to_blocks(state.scalars[k]), (N, N, N))
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(scalars_d[k]), atol=5e-4, err_msg=k
        )
    # physical sanity after 5 steps
    assert float(jnp.max(state.velocity[1])) > 0.01  # buoyant rise happened

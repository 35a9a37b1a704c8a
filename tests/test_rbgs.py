"""Red-black SOR pressure solve: textbook convergence of the XLA sweeps, and
the Pallas (Triton route) colour-sweep kernel in interpret mode against
them, plus the choice between the two."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnanosolver_tpu.core.topology import (
    active_mask,
    build_topology,
    build_topology_dense,
)
from hnanosolver_tpu.ops import pressure as prs
from hnanosolver_tpu.ops import rbgs_sweep as rs
from hnanosolver_tpu.ops import shifts as sh


def _residual_norms(topo, div, iters, dx=1.0, omega=1.0):
    """L2 residual after 0..iters sweeps (one jit, a scan over iterations)."""

    @jax.jit
    def run(div):
        def body(p, _):
            p = prs.solve_pressure(topo, div, 1, dx, omega, p0=p)
            r = prs.residual(topo, p, div, dx)
            return p, jnp.sqrt(jnp.sum(r * r))

        r0 = jnp.sqrt(jnp.sum(div * div))
        _, rs_ = jax.lax.scan(body, jnp.zeros_like(div), None, length=iters)
        return jnp.concatenate([r0[None], rs_])

    return np.asarray(run(div))


def _random_div(topo, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((topo.capacity, 512)).astype(np.float32)
    return jnp.asarray(d) * active_mask(topo)[:, None]


@pytest.mark.parametrize("n", [16, 24])
def test_gauss_seidel_asymptotic_rate_is_textbook(n):
    """omega = 1 on an n^3 box with zero (Dirichlet) background: the
    asymptotic residual reduction per red+black sweep is the Gauss-Seidel
    spectral radius cos^2(pi / (n + 1))."""
    topo = build_topology_dense((n, n, n))
    # past ~12 n sweeps the slower-decaying second mode has died out
    lo, hi = 12 * n, 16 * n
    norms = _residual_norms(topo, _random_div(topo), hi)
    rate = (norms[hi] / norms[lo]) ** (1.0 / (hi - lo))
    want = math.cos(math.pi / (n + 1)) ** 2
    assert abs(rate - want) < 2e-3, (rate, want)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_residual_decreases_every_sweep(kind):
    if kind == "dense":
        topo = build_topology_dense((24, 24, 24))
    else:
        rng = np.random.default_rng(2)
        box = np.array([(x, y, z) for x in range(5) for y in range(4)
                        for z in range(3)])
        topo = build_topology(box[rng.random(len(box)) < 0.6])
    norms = _residual_norms(topo, _random_div(topo, 1), 40)
    assert np.all(np.diff(norms) < 0), norms
    assert norms[-1] < 0.5 * norms[0]


def test_over_relaxation_beats_gauss_seidel():
    """SOR at the optimal omega = 2 / (1 + sin(pi / (n + 1))) converges
    faster than omega = 1 after the same sweeps."""
    n = 24
    topo = build_topology_dense((n, n, n))
    div = _random_div(topo, 3)
    w_opt = 2.0 / (1.0 + math.sin(math.pi / (n + 1)))
    gs = _residual_norms(topo, div, 60)[-1]
    sor = _residual_norms(topo, div, 60, omega=w_opt)[-1]
    assert sor < 0.1 * gs, (sor, gs)


# --- the Triton colour-sweep kernel, in interpret mode ---------------------

def _topos():
    rng = np.random.default_rng(4)
    box = np.array([(x, y, z) for x in range(4) for y in range(3)
                    for z in range(3)])
    return {
        "dense": build_topology_dense((24, 16, 16)),
        "sparse": build_topology(box[rng.random(len(box)) < 0.7]),
        "one_tile": build_topology(np.zeros((1, 3), np.int32)),
    }


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("kind", ["dense", "sparse", "one_tile"])
def test_sweep_kernel_matches_xla_sweeps(kind, iters):
    topo = _topos()[kind]
    div = _random_div(topo, 5)
    want = prs.solve_pressure(topo, div, iters, 0.5, 1.3)
    got = rs.solve(topo, div, iters, 0.5, 1.3, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sweep_kernel_continues_from_p0():
    topo = _topos()["sparse"]
    div = _random_div(topo, 6)
    p0 = prs.solve_pressure(topo, div, 2, 0.5, 1.0)
    want = prs.solve_pressure(topo, div, 2, 0.5, 1.0, p0=p0)
    got = rs.solve(topo, div, 2, 0.5, 1.0, p0=p0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_one_color_sweep_writes_only_its_color():
    topo = _topos()["sparse"]
    div = _random_div(topo, 7)
    p = _random_div(topo, 8)
    nb = rs.face_neighbors(topo)
    out = np.asarray(rs.color_sweep(nb, p, div, 0.25, 1.0, 0, interpret=True))
    col = np.arange(512)
    red = ((col >> 6) + ((col >> 3) & 7) + (col & 7)) % 2 == 0
    np.testing.assert_array_equal(out[:, ~red], np.asarray(p)[:, ~red])
    assert np.abs(out[:, red] - np.asarray(p)[:, red]).max() > 0


@pytest.mark.parametrize("capacity,want", [(4608, 4), (16, 4), (6, 2),
                                           (7, 1)])
def test_block_tiles_divides_capacity(capacity, want):
    assert rs.block_tiles(capacity) == want


def test_face_neighbors_follow_face_dirs():
    topo = _topos()["sparse"]
    nb = np.asarray(rs.face_neighbors(topo))
    for i, off in enumerate(sh.FACE_DIRS):
        np.testing.assert_array_equal(nb[i], np.asarray(topo.nbr)[:, sh.d_of(off)])


@pytest.mark.parametrize("platform,want", [("gpu", "triton"), ("cpu", "xla")])
def test_sweep_choice_by_platform(platform, want):
    assert prs.sweep_impl(platform) == want


def test_solve_pressure_routes_by_choice(monkeypatch):
    """The kernel takes the single-device solve only: a ghost ``refresh``
    (sharded step) or a coarse-level ``mask`` keeps the XLA sweeps."""
    calls = []
    monkeypatch.setattr(rs, "solve", lambda *a, **k: calls.append(1) or a[1])
    topo = _topos()["sparse"]
    div = _random_div(topo, 9)
    prs.solve_pressure(topo, div, 1, 0.5, 1.0)  # CPU: the XLA sweeps
    assert calls == []
    monkeypatch.setattr(prs, "sweep_impl", lambda: "triton")
    prs.solve_pressure(topo, div, 1, 0.5, 1.0)
    assert calls == [1]
    prs.solve_pressure(topo, div, 1, 0.5, 1.0, refresh=lambda f: f)
    prs.solve_pressure(topo, div, 1, 0.5, 1.0, mask=jnp.ones_like(div))
    assert calls == [1]

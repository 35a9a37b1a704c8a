"""BFECC advection on the gather path against an independent oracle.

The oracle traces every voxel in world index space with the global
binary-search samplers of ops/sampling.py (no 27-neighborhood tables, no
in-tile corner arithmetic) and applies the same scheme: CFL clamp, SDF
rejection of both traces, BFECC correction and the {self, 6 faces, phiF}
min-max limiter (`/root/reference/src/Cuda/Kernel.cu:118-453`).

Scenarios: {sparse, dense topology} x {scalars, velocity self-advection} x
{CFL 0.5, 2.5, 5, 6.9} x {SDF on, off}. At CFL 5 and 6.9 the BFECC re-trace
reaches the 7-voxel clamp, which the oracle applies too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnanosolver_tpu.core.layout import positions_flat
from hnanosolver_tpu.core.topology import (
    active_mask,
    build_topology,
    build_topology_dense,
)
from hnanosolver_tpu.ops import advection as adv
from hnanosolver_tpu.ops import collision as col
from hnanosolver_tpu.ops import sampling as S

ATOL = 5e-5  # f32: the two programs round trace positions differently
FACES = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def _topology(kind):
    if kind == "dense":
        return build_topology_dense((24, 24, 24))
    rng = np.random.default_rng(5)
    box = np.array([(x, y, z) for x in range(5) for y in range(4)
                    for z in range(4)])
    return build_topology(box[rng.random(len(box)) < 0.6])


def _smooth(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    for ax in (-1, -2):
        a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
    return a


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(topo, unit velocity [3,T,512], scalars, sphere SDF)."""
    topo = _topology(kind)
    T = topo.capacity
    rng = np.random.default_rng(11)
    m = np.asarray(active_mask(topo))[:, None]
    vel = _smooth(rng, (3, T, 512)) * m
    vel /= np.abs(vel).max()
    px, py, pz = (np.asarray(p, np.float32) for p in positions_flat(topo))
    c = np.array([px[m[:, 0] > 0].mean(), 14.0, 12.0], np.float32)
    blob = np.exp(-((px - c[0]) ** 2 + (py - c[1]) ** 2 + (pz - c[2]) ** 2)
                  / 40.0)
    scalars = {"density": jnp.asarray(blob * m),
               "noise": jnp.asarray(_smooth(rng, (T, 512)) * m)}
    sdf = np.sqrt((px - c[0]) ** 2 + (py - c[1] - 4.0) ** 2
                  + (pz - c[2]) ** 2) - 6.0
    return topo, jnp.asarray(vel), scalars, jnp.asarray(sdf * m)


@functools.partial(jax.jit, static_argnames=("sdt", "velocity_mode"))
def _oracle(topo, vel, fields, sdf, sdt, velocity_mode):
    T = topo.capacity
    lim = adv.DISP_LIMIT
    ipos = jnp.stack(positions_flat(topo), -1)  # [T,512,3] int
    pos = ipos.astype(jnp.float32)

    def samp(f, q):
        return S.sample_trilinear(topo, f.reshape(T, 8, 8, 8), q)

    d = jnp.clip(-jnp.moveaxis(vel, 0, -1) * sdt, -lim, lim)
    if sdf is not None:
        d = jnp.where((samp(sdf, pos + d) < 0.0)[..., None], 0.0, d)
    back = pos + d
    vf = jnp.stack([samp(vel[c], back) for c in range(3)], -1)
    d2 = jnp.clip(d + vf * sdt, -lim, lim)
    if sdf is not None:
        d2 = jnp.where((samp(sdf, pos + d2) < 0.0)[..., None], d, d2)
    fwd = pos + d2
    outs = []
    for phi in fields:
        pf, pb = samp(phi, back), samp(phi, fwd)
        lo, hi = jnp.minimum(phi, pf), jnp.maximum(phi, pf)
        for e in FACES:
            n = S.sample_nearest(topo, phi.reshape(T, 8, 8, 8),
                                 ipos + jnp.asarray(e, jnp.int32))
            lo, hi = jnp.minimum(lo, n), jnp.maximum(hi, n)
        outs.append(jnp.clip(pf + 0.5 * (phi - pb), lo, hi))
    out = jnp.stack(outs)
    if velocity_mode and sdf is not None:
        out = col.enforce_collision(topo, out, sdf, 1.0, margin=0.1,
                                    blend_denom=1.5)
    return out


_scalars = jax.jit(adv.advect_scalars_fused,
                   static_argnames=("dt", "inv_dx"))
_velocity = jax.jit(adv.advect_velocity, static_argnames=("dt", "inv_dx"))


@pytest.mark.parametrize("sdf_on", [False, True], ids=["nosdf", "sdf"])
@pytest.mark.parametrize("cfl", [0.5, 2.5, 5.0, 6.9])
@pytest.mark.parametrize("mode", ["scalars", "velocity"])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_gather_bfecc_matches_global_sampler_oracle(kind, mode, cfl, sdf_on):
    topo, unit_vel, scalars, sdf = _case(kind)
    vel = unit_vel * cfl  # max |u| * dt / dx == cfl (dt = dx = 1)
    sdf = sdf if sdf_on else None
    if mode == "scalars":
        names = sorted(scalars)
        got = _scalars(topo, vel, scalars, 1.0, 1.0, sdf)
        got = jnp.stack([got[k] for k in names])
        want = _oracle(topo, vel, [scalars[k] for k in names], sdf, 1.0,
                       False)
    else:
        got = _velocity(topo, vel, 1.0, 1.0, sdf)
        want = _oracle(topo, vel, [vel[0], vel[1], vel[2]], sdf, 1.0, True)
    mb = np.asarray(active_mask(topo)).astype(bool)
    got, want = np.asarray(got)[:, mb], np.asarray(want)[:, mb]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the scenario must move data: outputs differ from the inputs
    src = (np.stack([np.asarray(scalars[k]) for k in sorted(scalars)])
           if mode == "scalars" else np.asarray(vel))[:, mb]
    assert np.abs(got - src).max() > 1e-3

"""The byte-cap governors switch to lower-peak forms of the same arithmetic:
with each cap forced small, results must match the default single-shot
forms bit for bit (the caps engage only at 1024^3-class domains, so these
tests are what keeps those branches honest).

One exception: ADVECT_TRANSIENT_BUDGET splits the advected fields into
batches, and XLA's CPU code generator contracts multiply-adds differently
when a fused loop carries one field instead of several, so those results
agree to about ten ulps (measured up to 1e-6 on values near 1), not bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnanosolver_tpu.core.topology import active_mask, build_topology
from hnanosolver_tpu.ops import advection as adv
from hnanosolver_tpu.ops import multigrid as mg
from hnanosolver_tpu.ops import pressure as prs
from hnanosolver_tpu.ops import shifts as sh
from hnanosolver_tpu.ops import stencil as stn


def _case():
    rng = np.random.default_rng(3)
    box = np.array([(x, y, z) for x in range(4) for y in range(4)
                    for z in range(3)])
    topo = build_topology(box[rng.random(len(box)) < 0.7])
    m = np.asarray(active_mask(topo))[:, None]
    T = topo.capacity
    vel = (rng.standard_normal((3, T, 512)).astype(np.float32) * 1.5) * m
    scal = {k: rng.random((T, 512)).astype(np.float32) * m
            for k in ("density", "fuel", "temperature")}
    return topo, vel, scal


def _run(what, topo, vel, scal):
    # a fresh jit per call, so a patched cap is read when tracing
    lvl = mg.build_hierarchy(topo, 1)[0] if what == "prolong" else None
    return np.asarray(
        jax.jit(lambda v, s: _ops(what, topo, v, s, lvl))(vel, scal))


def _ops(what, topo, vel, scal, lvl):
    if what == "advect_scalars":
        out = adv.advect_scalars_fused(topo, vel, scal, 0.5, 1.0)
        return jnp.stack([out[k] for k in sorted(out)])
    if what in ("advect_velocity", "sampling_chunk"):
        chunk = 4 if what == "sampling_chunk" else adv.DEFAULT_CHUNK
        return adv.advect_velocity(topo, vel, 0.5, 1.0, chunk=chunk)
    if what == "face_minmax":
        lo, hi = sh.face_minmax_multi(topo, jnp.stack(list(scal.values())))
        return jnp.stack([lo, hi])
    if what == "pressure":
        return prs.solve_pressure(topo, scal["density"], 3, 0.5, 1.0)
    if what == "divergence":
        return stn.divergence(topo, vel, 2.0)
    if what == "gradient":
        return stn.subtract_pressure_gradient(topo, vel, scal["fuel"], 2.0)
    if what == "prolong":
        coarse = scal["density"][: lvl.topo.capacity]
        return jnp.stack([mg.prolong(lvl, coarse, topo.capacity),
                          mg.prolong_trilinear(lvl, coarse)])
    raise ValueError(what)


# (what runs, module holding the cap, cap name)
CASES = [
    ("advect_scalars", adv, "ADVECT_TRANSIENT_BUDGET"),
    ("advect_velocity", adv, "ADVECT_TRANSIENT_BUDGET"),
    ("advect_scalars", sh, "MINMAX_VIEWS_BUDGET"),
    ("face_minmax", sh, "MINMAX_VIEWS_BUDGET"),
    ("advect_scalars", adv, "CLAMP_VIEWS_BUDGET"),
    ("pressure", sh, "NBRSUM_VIEWS_BUDGET"),
    ("divergence", sh, "NBRSUM_VIEWS_BUDGET"),
    ("gradient", sh, "NBRSUM_VIEWS_BUDGET"),
    ("prolong", mg, "PROLONG_MERGE_BUDGET"),
    ("sampling_chunk", None, None),
]


@pytest.mark.parametrize(
    "what,module,cap", CASES,
    ids=[f"{w}-{c or 'chunk'}" for w, _, c in CASES])
def test_governor_is_bit_identical(what, module, cap, monkeypatch):
    topo, vel, scal = _case()
    want = _run("advect_velocity" if what == "sampling_chunk" else what,
                topo, vel, scal)
    if module is not None:
        monkeypatch.setattr(module, cap, 1)
    got = _run(what, topo, vel, scal)
    assert np.isfinite(got).all()
    if cap == "ADVECT_TRANSIENT_BUDGET":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_chunk_size_divides_capacity():
    # the bench envelope's capacity (9 x 512) takes 768-tile chunks
    assert adv.chunk_size(4608) == 768
    for cap in (16, 1024, 2048, 4608, 6144, 269_312):
        c = adv.chunk_size(cap)
        assert cap % c == 0 and c <= adv.DEFAULT_CHUNK
    assert adv.chunk_size(16) == 16
    assert adv.chunk_size(6144) == 1024

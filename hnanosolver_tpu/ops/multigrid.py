"""Geometric multigrid pressure solver on the sparse tile hierarchy.

The reference *intended* a multigrid V-cycle — kernels are declared
(`/root/reference/src/Cuda/Kernels.cuh:40-49`), one restriction is written
(`Kernel.cu:625-658`), and the whole host driver exists as a comment
(`HNanoSolver.cu:399-506`) — but none of it runs (SURVEY §7.6). This module
implements it for real, on the flat tile layout:

- Level k+1 tiles are the unique ``tile_coord >> 1`` of level k — each
  coarse 8^3 tile covers a 2x2x2 block of fine tiles, so restriction /
  prolongation are pure row-gathers + reshapes (no element gathers).
- Restriction: 2x2x2 averaging (full-weighting lite — exactly the
  reference's restrict_to_4x4x4 scheme at tile scale).
- Prolongation: trilinear (cell-centered) by default — per-axis even/odd
  1-D interpolants evaluated on the coarse grid (6 shifted views per
  doubling) then an octant gather, so cross-tile interpolation costs row
  gathers only. Piecewise-constant injection remains as ``prolong``.
- Smoother: the same red-black SOR sweep as the direct solver
  (ops/pressure.py), so a 0-level hierarchy degenerates to plain RBGS.

The discrete operator at every level is the 7-point Laplacian
L(p) = (sum_nbr p - 6 p) / dx^2 with Dirichlet-0 background (null tile),
with dx doubling per level.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from hnanosolver_tpu.core import coords as C
from hnanosolver_tpu.core.topology import Topology, build_topology
from hnanosolver_tpu.ops import pressure as prs
from hnanosolver_tpu.ops import shifts as sh


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One coarse level: its topology plus child/parent row maps.

    ``mask`` marks coarse voxels whose child fine tile exists (each coarse
    voxel's 2^3 fine voxels lie in exactly one child tile, so this is the
    EXACT fine domain geometry at half resolution). Without it the coarse
    solve runs on the dilated coarse-tile domain — a different BVP whose
    corrections overshoot at sparse boundaries (measured: V-cycles diverge
    on the 256^3 plume cone)."""

    topo: Topology
    children: jax.Array  # [Tc, 8] fine-level rows per octant (0 = absent)
    parent: jax.Array  # [Tf] coarse-level row of each fine tile (0 = none)
    octant: jax.Array  # [Tf] in {0..7}: (tx&1)*4 + (ty&1)*2 + (tz&1)
    mask: jax.Array  # [Tc, 512] f32: 1 where the covering child tile exists

    def tree_flatten(self):
        return (self.topo, self.children, self.parent, self.octant, self.mask), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch)


def _restrict_mask_np(children: np.ndarray, fine_mask: np.ndarray,
                      mode: str = "any") -> np.ndarray:
    """Coarse in-domain mask, restricted from the fine level's mask (numpy
    mirror of :func:`restrict` with a min/max reduction). Carrying the mask
    as restricted DATA keeps it voxel-exact at every depth; the round-2
    tile-existence derivation was exact only for level 1 (below that,
    level-k tiles are themselves partially in-domain, so existence
    over-covers — measured to diverge at depth >= 3).

    ``mode``: "any" marks a coarse voxel in-domain when ANY of its 2^3 fine
    children is — the coarse domain OVER-covers the fine one by up to
    2^k - 1 voxels at depth k, so coarse corrections of the global mode
    overshoot (a Dirichlet problem on a larger domain has a larger
    solution) and deep V-cycles amplify instead of damping. "all" (the
    default) requires every child in-domain: the coarse domain
    under-covers, corrections undershoot, and the cycle can only damp —
    deeper is then strictly better on the tile sphere (test_multigrid)."""
    Tf = fine_mask.shape[0]
    red = np.max if mode == "any" else np.min
    m = red(fine_mask.reshape(Tf, 4, 2, 4, 2, 4, 2), axis=(2, 4, 6))
    Tc = children.shape[0]
    ch = m[children.reshape(-1)].reshape(Tc, 2, 2, 2, 4, 4, 4)
    out = np.moveaxis(ch, (1, 2, 3), (1, 3, 5))  # [Tc, 2,4, 2,4, 2,4]
    return out.reshape(Tc, 512)


def build_hierarchy(topo: Topology, levels: int,
                    mask_mode: str = "all") -> List[MGLevel]:
    """Host-side construction of ``levels`` coarse levels below ``topo``."""
    out: List[MGLevel] = []
    fine = topo
    nf0 = int(topo.n_active)
    fine_mask = np.zeros((topo.capacity, 512), np.float32)
    fine_mask[1 : nf0 + 1] = 1.0  # fine active tiles are fully in-domain
    for _ in range(levels):
        nf = int(fine.n_active)
        fo = np.asarray(fine.origins[1 : nf + 1])  # fine tile coords
        co = fo >> 1
        coarse = build_topology(co)
        nc = int(coarse.n_active)

        # parent row per fine tile
        ckeys = np.asarray(coarse.keys)[1 : nc + 1]
        pk = C.pack_keys_np(co)
        prow = (np.searchsorted(ckeys, pk) + 1).astype(np.int32)
        parent = np.zeros(fine.capacity, np.int32)
        parent[1 : nf + 1] = prow
        oct_ = np.zeros(fine.capacity, np.int32)
        oct_[1 : nf + 1] = ((fo[:, 0] & 1) * 4 + (fo[:, 1] & 1) * 2 + (fo[:, 2] & 1))

        # children rows per coarse tile
        children = np.zeros((coarse.capacity, 8), np.int32)
        children[prow, oct_[1 : nf + 1]] = np.arange(1, nf + 1, dtype=np.int32)

        mask = _restrict_mask_np(children, fine_mask, mask_mode)

        out.append(
            MGLevel(
                topo=coarse,
                children=jnp.asarray(children),
                parent=jnp.asarray(parent),
                octant=jnp.asarray(oct_),
                mask=jnp.asarray(mask),
            )
        )
        fine = coarse
        fine_mask = mask
    return out


def hierarchy_for(topo: Topology, params) -> tuple:
    """The hierarchy tuple ``solver.step`` expects for ``params``: empty for
    the RBGS solver, ``params.mg_levels`` coarse levels for "mg". Host-side;
    call after every topology (re)build."""
    if getattr(params, "pressure_solver", "rbgs") != "mg":
        return ()
    return tuple(build_hierarchy(topo, params.mg_levels))


# ---------------------------------------------------------------------------
# Transfer operators.
#
# All index juggling is precomputed as static in-tile column permutations
# so every on-device array stays [T, 512]-shaped (or [T, small]): no
# [.., 8, 8, 8] / [.., 4, 4, 4] intermediates whose small minor dims a
# backend may pad.
# ---------------------------------------------------------------------------


def _lane_xyz(l: np.ndarray):
    return l // 64, (l // 8) % 8, l % 8


_L = np.arange(512)
_LX, _LY, _LZ = _lane_xyz(_L)
# restrict step 2: the 64 even-corner lanes holding each 2x2x2 block sum
_IDX_DOWN = np.asarray(
    [128 * a + 16 * b + 2 * c
     for a in range(4) for b in range(4) for c in range(4)], np.int32)
# restrict step 3: from octant-major [o*64 + k] to the coarse flat lane
_PERM_ASSEMBLE = np.empty(512, np.int32)
for _l in range(512):
    _cx, _cy, _cz = _LX[_l], _LY[_l], _LZ[_l]
    _o = (_cx // 4) * 4 + (_cy // 4) * 2 + (_cz // 4)
    _k = (_cx % 4) * 16 + (_cy % 4) * 4 + (_cz % 4)
    _PERM_ASSEMBLE[_l] = _o * 64 + _k
# prolongation: per fine-tile octant o, the parent lane covering fine lane l
_IDX_OCT = np.empty((8, 512), np.int32)
for _o in range(8):
    _ox, _oy, _oz = (_o >> 2) & 1, (_o >> 1) & 1, _o & 1
    _IDX_OCT[_o] = ((_ox * 4 + _LX // 2) * 64 + (_oy * 4 + _LY // 2) * 8
                    + (_oz * 4 + _LZ // 2))
# trilinear prolongation: parity-field index q = pz*4 + py*2 + px per lane,
# combined with the octant lane into one index over the [8, 512] lane-space
_Q = (_LZ & 1) * 4 + (_LY & 1) * 2 + (_LX & 1)
_IDX_OCT_Q = (_Q[None, :] * 512 + _IDX_OCT).astype(np.int32)  # [8, 512]


def restrict(level: MGLevel, fine: jax.Array) -> jax.Array:
    """[Tf,512] -> [Tc,512] (flat layout): average 2x2x2 fine voxels,
    assemble the 8 child tiles into the coarse tile's octants."""
    Tc = level.children.shape[0]
    # pairwise sums along z, y, x via lane rolls; the wrap garbage lands on
    # odd lanes, which the even-corner selection below never reads
    s = fine + jnp.roll(fine, -1, axis=1)
    s = s + jnp.roll(s, -8, axis=1)
    s = s + jnp.roll(s, -64, axis=1)
    down = jnp.take(s, jnp.asarray(_IDX_DOWN), axis=1) * 0.125  # [Tf, 64]
    ch = jnp.take(down, level.children.reshape(-1), axis=0)
    ch = ch.reshape(Tc, 512)  # octant-major [o*64 + k]
    return jnp.take(ch, jnp.asarray(_PERM_ASSEMBLE), axis=1)


# Above this many bytes for the [Tc*8, 512] octant-expanded coarse array,
# prolongation falls back to the 8-sequential-gather form (lower peak, more
# passes) — the merged form holds source + expansion + output at once. A
# memory cap that engages only at 1024^3-class domains; its value predates
# any measurement on this device (re-derive at the 1024^3 cell).
PROLONG_MERGE_BUDGET = 1 * 1024**3


def prolong(level: MGLevel, coarse: jax.Array, fine_capacity: int) -> jax.Array:
    """[Tc,512] -> [Tf,512] (flat layout): pick each fine tile's 4^3 octant
    of its parent and upsample 2x (piecewise constant).

    One lane permutation expands the coarse rows to all 8 octant views
    [Tc*8, 512]; one row gather (parent*8 + octant) lands every fine tile —
    vs 8 full fine-size gather+select passes (bit-identical values, same
    lane maps)."""
    Tc = coarse.shape[0]
    if Tc * 8 * 512 * 4 <= PROLONG_MERGE_BUDGET:
        sel = jnp.take(coarse, jnp.asarray(_IDX_OCT.reshape(-1)), axis=1)
        sel = sel.reshape(Tc * 8, 512)
        return jnp.take(sel, level.parent * 8 + level.octant, axis=0)
    par = jnp.take(coarse, level.parent, axis=0)  # [Tf, 512]
    out = jnp.zeros_like(par)
    oct_ = level.octant[:, None]
    for o in range(8):
        cand = jnp.take(par, jnp.asarray(_IDX_OCT[o]), axis=1)
        out = jnp.where(oct_ == o, cand, out)
    return out


def _shifted_view_batch(topo: Topology, fs: jax.Array, off) -> jax.Array:
    """shifts.shifted_view over a stack of fields [k,T,512] with ONE row
    gather for all k (null tile of field f is its own row f*T)."""
    k, T, _ = fs.shape
    mask, s_in, s_fix = sh._DIRS[tuple(off)]
    flat = fs.reshape(k * T, 512)
    idx = (
        topo.nbr[:, sh.d_of(off)][None, :]
        + (jnp.arange(k, dtype=jnp.int32) * T)[:, None]
    ).reshape(-1)
    n = jnp.take(flat, idx, axis=0).reshape(k, T, 512)
    return jnp.where(mask[None], jnp.roll(n, s_fix, 2), jnp.roll(fs, s_in, 2))


def prolong_trilinear(level: MGLevel, coarse: jax.Array) -> jax.Array:
    """[Tc,512] -> [Tf,512]: trilinear (cell-centered) interpolation of the
    coarse correction at fine voxel centers — the textbook pairing that the
    reference's commented V-cycle declares as ``prolongate``
    (`/root/reference/src/Cuda/Kernels.cuh:40-49`).

    A fine voxel at even (odd) index along an axis sits at coarse offset
    -0.25 (+0.25), so its 1-D weights are 0.75 on its parent cell and 0.25
    on the -1 (+1) coarse neighbor. The 8 parity combinations are evaluated
    on the COARSE grid (batched shifted views there — 6 gathers total), then
    each fine tile reads its parent's octant from the stacked parity fields
    through one static lane permutation per octant (combined parity+octant
    index over the [8, 512] lane-space — no [.., 8, 8, 8]-shaped
    intermediates, see the transfer-operator note above). Out-of-domain
    coarse reads are 0 (Dirichlet)."""
    topo_c = level.topo
    fields = coarse[None]  # [1, Tc, 512]
    for axis in range(3):
        off_m = tuple(-1 if a == axis else 0 for a in range(3))
        off_p = tuple(+1 if a == axis else 0 for a in range(3))
        lo = 0.75 * fields + 0.25 * _shifted_view_batch(topo_c, fields, off_m)
        hi = 0.75 * fields + 0.25 * _shifted_view_batch(topo_c, fields, off_p)
        fields = jnp.concatenate([lo, hi], axis=0)
    # stacking order: axis-k parity lands in bit k => index q = pz*4+py*2+px
    Tc = coarse.shape[0]
    stacked = jnp.moveaxis(fields, 0, 1).reshape(Tc, 8 * 512)
    # column-select per octant on the COARSE side, THEN row-gather to fine:
    # gathering [Tf, 4096] first is a 4.1 GB temp at 1024^3; this order is
    # the same two takes commuted, peaking at [Tc, 4096] + 2x [Tf, 512].
    if Tc * 8 * 512 * 4 <= PROLONG_MERGE_BUDGET:
        # merged form: ONE lane permutation expands the parity stack to all
        # 8 octant views [Tc*8, 512], ONE row gather (parent*8 + octant)
        # lands every fine tile — vs 8 full fine-size gather+select passes
        # (bit-identical: same lane maps, same source values)
        sel = jnp.take(stacked, jnp.asarray(_IDX_OCT_Q.reshape(-1)), axis=1)
        sel = sel.reshape(Tc * 8, 512)
        return jnp.take(sel, level.parent * 8 + level.octant, axis=0)
    out = jnp.zeros((level.parent.shape[0], 512), coarse.dtype)
    oct_ = level.octant[:, None]
    for o in range(8):
        cand_c = jnp.take(stacked, jnp.asarray(_IDX_OCT_Q[o]), axis=1)
        cand = jnp.take(cand_c, level.parent, axis=0)  # [Tf, 512]
        out = jnp.where(oct_ == o, cand, out)
    return out


def v_cycle(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: jax.Array,
    p: jax.Array,
    dx: float,
    omega: float,
    n_pre: int = 2,
    n_post: int = 2,
    n_coarsest: int = 24,
    prolongation: str = "trilinear",
    mask: jax.Array | None = None,
    refresh=None,
    coarse_reduce=None,
) -> jax.Array:
    """One V-cycle of the reference's commented driver (HNanoSolver.cu:399-506),
    recursing down ``hierarchy``. ``mask`` is THIS level's in-domain voxel
    mask (None at the fine level, whose active tiles are fully in-domain).

    ``refresh`` (ghost exchange) is applied inside the FINE-level smoothers
    only. Sharded multigrid (parallel/slab.py) replicates the coarse levels:
    each device restricts its OWNED fine tiles into the global coarse table
    and ``coarse_reduce`` (a psum over the mesh axis) combines them; the
    coarse solve then runs identically on every device."""
    if not hierarchy:
        # the coarsest call is a solve, not a smoother
        return prs.solve_pressure(
            topo, div, n_coarsest, dx, omega, p0=p, mask=mask,
            refresh=refresh,
        )
    lvl = hierarchy[0]
    p = prs.solve_pressure(
        topo, div, n_pre, dx, omega, p0=p, mask=mask, refresh=refresh
    )
    if refresh is not None:
        p = refresh(p)
    r = prs.residual(topo, p, div, dx)
    if mask is not None:
        r = r * mask
    rc = restrict(lvl, r)
    if coarse_reduce is not None:
        rc = coarse_reduce(rc)
    rc = rc * lvl.mask
    # NOTE: refresh/coarse_reduce are deliberately NOT passed down — their
    # exchange maps are fine-level; coarse levels run refresh-free (single
    # chip) or replicated on every device (sharded, parallel/slab.py).
    ec = v_cycle(
        lvl.topo,
        hierarchy[1:],
        rc,
        jnp.zeros_like(rc),
        dx * 2.0,
        omega,
        n_pre,
        n_post,
        n_coarsest,
        prolongation,
        lvl.mask,
    )
    if prolongation == "trilinear":
        p = p + prolong_trilinear(lvl, ec)
    else:
        p = p + prolong(lvl, ec, topo.capacity)
    return prs.solve_pressure(
        topo, div, n_post, dx, omega, p0=p, mask=mask, refresh=refresh
    )


def fmg_initial_guess(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: jax.Array,
    dx: float,
    omega: float,
    n_pre: int = 2,
    n_post: int = 2,
    n_coarsest: int = 24,
    prolongation: str = "trilinear",
    refresh=None,
    coarse_reduce=None,
) -> jax.Array:
    """Full-multigrid (nested-iteration) initial guess: restrict the RHS to
    every level, solve the coarsest, then per level prolong the SOLUTION up
    and refine with one V-cycle at that level. Costs ~one extra coarse-side
    V-cycle (fine-level work: one V-cycle's worth at most) and replaces the
    first 1-2 fine V-cycles a zero guess would need on the global mode —
    the standard FMG recipe.

    Sharded (``refresh``/``coarse_reduce`` from parallel/slab.py): only the
    FINE level is sharded — the level-0→1 restriction of the RHS goes
    through ``coarse_reduce`` (a psum combining each device's owned-rows
    partial, exactly as in ``v_cycle``), every level ≥ 1 runs replicated
    (identical deterministic compute on all devices, no exchange), and the
    final level-0 V-cycle threads ``refresh`` through its smoothers. The
    prolongation back to level 0 needs no refresh: each device's parent/
    octant maps cover its ghost rows too, and the source correction is
    replicated."""
    divs = [div]
    for i, lvl in enumerate(hierarchy):
        r = restrict(lvl, divs[-1])
        if i == 0 and coarse_reduce is not None:
            r = coarse_reduce(r)
        divs.append(r * lvl.mask)
    # coarsest solve (replicated when sharded: level >= 1 by construction —
    # fmg callers require a non-empty hierarchy)
    last = hierarchy[-1]
    p = prs.solve_pressure(
        last.topo, divs[-1], n_coarsest, dx * (2.0 ** len(hierarchy)),
        omega, mask=last.mask,
    )
    for k in reversed(range(len(hierarchy))):
        lvl = hierarchy[k]
        if prolongation == "trilinear":
            p = prolong_trilinear(lvl, p)
        else:
            p = prolong(lvl, p, divs[k].shape[0])
        t_k = topo if k == 0 else hierarchy[k - 1].topo
        m_k = None if k == 0 else hierarchy[k - 1].mask
        if m_k is not None:
            p = p * m_k
        p = v_cycle(
            t_k, hierarchy[k:], divs[k], p, dx * (2.0 ** k), omega,
            n_pre, n_post, n_coarsest, prolongation, m_k,
            refresh=refresh if k == 0 else None,
            coarse_reduce=coarse_reduce if k == 0 else None,
        )
    return p


def solve_pressure_mg(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: jax.Array,
    cycles: int,
    dx: float,
    omega: float = 1.0,
    tol: float | None = None,
    refresh=None,
    coarse_reduce=None,
    fmg: bool = False,
    tol_reduce=None,
    **kw,
) -> jax.Array:
    """``cycles`` V-cycles from a zero initial guess (or an FMG nested-
    iteration guess with ``fmg=True`` — sharded callers included, see
    ``fmg_initial_guess``).

    With ``tol`` set, cycles stop early once ``max|r|/max|div| <= tol``
    (``cycles`` becomes the cap) — solve-to-residual rather than
    solve-by-count, the criterion SURVEY §7.4 prescribes for parity.
    ``tol_reduce(arr) -> scalar`` maps a residual field to its global max;
    the default is a plain ``max|.|``, and the sharded step passes an
    owned-rows-masked ``pmax`` over the mesh axis so every device sees the
    same stopping decision (SURVEY §5.7's psum-reduction recipe)."""
    kw["refresh"] = refresh
    kw["coarse_reduce"] = coarse_reduce
    if fmg and hierarchy:
        p = fmg_initial_guess(
            topo, hierarchy, div, dx, omega,
            n_pre=kw.get("n_pre", 2), n_post=kw.get("n_post", 2),
            n_coarsest=kw.get("n_coarsest", 24),
            prolongation=kw.get("prolongation", "trilinear"),
            refresh=refresh, coarse_reduce=coarse_reduce,
        )
    else:
        p = jnp.zeros_like(div)
    if tol is None:
        for _ in range(cycles):
            p = v_cycle(topo, hierarchy, div, p, dx, omega, **kw)
        return p

    if tol_reduce is None:
        tol_reduce = lambda a: jnp.max(jnp.abs(a))  # noqa: E731
    scale = jnp.maximum(tol_reduce(div), 1e-30)

    def rmax_of(p):
        # a V-cycle's output ghosts are one half-sweep stale — refresh
        # before the residual so owned rows at slab boundaries are exact
        pr = refresh(p) if refresh is not None else p
        return tol_reduce(prs.residual(topo, pr, div, dx))

    # the residual is computed in the BODY and carried, so the while cond
    # is collective-free — XLA requires a replicated cond computation, and
    # a carried pmax'd scalar is identical on every device by construction
    def cond(carry):
        i, p, rmax = carry
        return (i < cycles) & (rmax > tol * scale)

    def body(carry):
        i, p, _ = carry
        p = v_cycle(topo, hierarchy, div, p, dx, omega, **kw)
        return i + 1, p, rmax_of(p)

    return jax.lax.while_loop(
        cond, body, (jnp.asarray(0), p, rmax_of(p))
    )[1]

"""One red-black SOR colour sweep as a Pallas kernel on the Triton route.

The same update as ``pressure._color_sweep`` (the reference's
redBlackGaussSeidelUpdate, `/root/reference/src/Cuda/Kernel.cu:591-623`),
in one launch per colour instead of XLA's gather + fused update:

- each program owns ``BLOCK_TILES`` consecutive tile rows; it reads its own
  rows, and from each of the six ``topo.nbr`` face neighbours only the
  64-voxel plane that touches the tile (a per-voxel pointer gather: in-tile
  neighbours come from the tile's own row, boundary voxels from the
  neighbour row);
- it writes only the voxels of the active colour, in place (``p`` is
  aliased to the output).

In place is race-free: a voxel's six neighbours all have the other colour
(tile origins are multiples of 8, so colour = in-tile parity), and only the
active colour is written during a sweep. The summation order is the one of
``shifts.neighbor_sum`` (+x, -x, +y, -y, +z, -z, left to right).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hnanosolver_tpu.core.layout import TILE
from hnanosolver_tpu.core.topology import Topology
from hnanosolver_tpu.ops import shifts as sh

BLOCK_TILES = 4  # tile rows per program (a power of two)
NUM_WARPS = 4

# (axis, boundary coordinate, in-tile column offset, neighbour column offset)
# per face direction, in shifts.FACE_DIRS order; read from shifts._DIRS so
# the two formulations cannot drift apart.
_FACES = tuple(
    (max(range(3), key=lambda a, o=off: abs(o[a])),
     7 if sum(off) > 0 else 0, -sh._DIRS[off][1], -sh._DIRS[off][2])
    for off in sh.FACE_DIRS
)


def block_tiles(capacity: int) -> int:
    """Tile rows per program: BLOCK_TILES, or the largest power of two that
    divides ``capacity`` if that is smaller."""
    b = BLOCK_TILES
    while capacity % b:
        b //= 2
    return b


def _sweep_kernel(nbr_ref, div_ref, p_ref, out_ref, *, color, dx2, omega,
                  bt):
    pid = pl.program_id(0)
    rows1 = pid * bt + jax.lax.broadcasted_iota(jnp.int32, (bt,), 0)
    rows = jnp.broadcast_to(rows1[:, None], (bt, TILE))
    col = jax.lax.broadcasted_iota(jnp.int32, (bt, TILE), 1)
    coord = (col >> 6, (col >> 3) & 7, col & 7)

    p = p_ref[rows, col]
    acc = None
    for i, (axis, edge, s_in, s_nb) in enumerate(_FACES):
        nb = jnp.broadcast_to(nbr_ref[i, rows1][:, None], (bt, TILE))
        at_edge = coord[axis] == edge
        v = p_ref[jnp.where(at_edge, nb, rows),
                  jnp.where(at_edge, col + s_nb, col + s_in)]
        acc = v if acc is None else acc + v
    pgs = (acc - div_ref[rows, col] * dx2) * (1.0 / 6.0)
    new = p + omega * (pgs - p)
    active = ((coord[0] + coord[1] + coord[2]) & 1) == color
    plgpu.store(out_ref.at[rows, col], new, mask=active)


def color_sweep(nbr6t: jax.Array, p: jax.Array, div: jax.Array, dx2: float,
                omega: float, color: int, interpret: bool = False):
    """One colour sweep over ``p [T,512]``. ``nbr6t [6,T]``: face-neighbour
    rows in FACE_DIRS order (see ``face_neighbors``)."""
    T = p.shape[0]
    bt = block_tiles(T)
    kernel = functools.partial(_sweep_kernel, color=color, dx2=dx2,
                               omega=omega, bt=bt)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(p.shape, p.dtype),
        grid=(T // bt,),
        input_output_aliases={2: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"rbgs_sweep_{'red' if color == 0 else 'black'}",
    )(nbr6t, div, p)


def face_neighbors(topo: Topology) -> jax.Array:
    """[6, T] int32: each tile's face-neighbour row per FACE_DIRS entry."""
    cols = np.asarray([sh.d_of(off) for off in sh.FACE_DIRS])
    return topo.nbr[:, cols].T


def solve(topo: Topology, div: jax.Array, iterations: int, dx: float,
          omega: float, p0: jax.Array | None = None,
          interpret: bool = False) -> jax.Array:
    """``iterations`` red+black sweeps; the same result as
    ``pressure.solve_pressure`` without ``refresh`` or ``mask``."""
    nbr6t = face_neighbors(topo)
    dx2 = dx * dx
    p = jnp.zeros_like(div) if p0 is None else p0

    def body(_, p):
        p = color_sweep(nbr6t, p, div, dx2, omega, 0, interpret)
        return color_sweep(nbr6t, p, div, dx2, omega, 1, interpret)

    return jax.lax.fori_loop(0, iterations, body, p)

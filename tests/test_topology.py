"""Topology invariants — the port of the reference's data-layer tests
(`/root/reference/Tests/IndexGrid.cpp`: IndexGridBuilderTest, IndexSamplerTest)
to the tile-table design."""

import jax.numpy as jnp
import numpy as np
import pytest

from hnanosolver_tpu.core import coords as C
from hnanosolver_tpu.core.topology import (
    Topology,
    active_mask,
    build_topology,
    build_topology_dense,
    dilate_topology,
    lookup_tiles,
    lookup_voxels,
    voxel_positions,
)


def test_pack_unpack_roundtrip(rng):
    tiles = rng.integers(-C.TILE_OFFSET, C.TILE_OFFSET, size=(1000, 3)).astype(
        np.int32
    )
    keys = C.pack_keys(jnp.asarray(tiles))
    back = np.asarray(C.unpack_keys(keys))
    np.testing.assert_array_equal(back, tiles)
    # numpy twin agrees
    np.testing.assert_array_equal(np.asarray(keys), C.pack_keys_np(tiles))


def test_pack_order_is_lexicographic(rng):
    tiles = rng.integers(-50, 50, size=(500, 3)).astype(np.int32)
    keys = C.pack_keys_np(tiles)
    order_k = np.argsort(keys, kind="stable")
    order_l = np.lexsort((tiles[:, 2], tiles[:, 1], tiles[:, 0]))
    np.testing.assert_array_equal(keys[order_k], keys[order_l])


def test_build_dedups_and_sorts(rng):
    tiles = rng.integers(-4, 4, size=(200, 3)).astype(np.int32)
    topo = build_topology(tiles)
    n_unique = len({tuple(t) for t in tiles})
    assert topo.n_active == n_unique
    assert topo.num_voxels == n_unique * 512
    keys = np.asarray(topo.keys)
    assert keys[0] == C.NULL_KEY
    assert np.all(np.diff(keys[1 : topo.n_active + 1]) > 0)  # strictly sorted
    assert np.all(keys[topo.n_active + 1 :] == C.PAD_KEY)


def test_lookup_hits_and_misses(rng):
    tiles = np.array([[0, 0, 0], [1, 0, 0], [-3, 2, 7], [5, 5, 5]], np.int32)
    topo = build_topology(tiles)
    ids = np.asarray(lookup_tiles(topo, jnp.asarray(tiles)))
    assert np.all(ids > 0)
    # each id maps back to the right origin
    origins = np.asarray(topo.origins)[ids]
    np.testing.assert_array_equal(origins, tiles)
    # misses -> 0
    misses = np.array([[9, 9, 9], [-100, 0, 0], [0, 0, 1]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(lookup_tiles(topo, jnp.asarray(misses))), 0
    )
    # out-of-packable-range coords must be rejected, not aliased
    wild = np.array([[1 << 20, 1 << 20, 1 << 20], [-(1 << 15), 0, 0]], np.int32)
    np.testing.assert_array_equal(np.asarray(lookup_tiles(topo, jnp.asarray(wild))), 0)


def test_lookup_voxels_background():
    topo = build_topology(np.array([[0, 0, 0]], np.int32))
    # active voxel (3,4,5) -> tile 1, local flat (3*8+4)*8+5
    idx = int(lookup_voxels(topo, jnp.array([3, 4, 5], jnp.int32)))
    assert idx == 512 + (3 * 8 + 4) * 8 + 5
    # inactive voxel -> inside null tile rows [0, 512)
    idx0 = int(lookup_voxels(topo, jnp.array([100, 0, 0], jnp.int32)))
    assert 0 <= idx0 < 512
    # negative coords use arithmetic shift: voxel -1 belongs to tile -1
    topo2 = build_topology(np.array([[-1, -1, -1]], np.int32))
    idx2 = int(lookup_voxels(topo2, jnp.array([-1, -1, -1], jnp.int32)))
    assert idx2 == 512 + (7 * 8 + 7) * 8 + 7


def test_neighbor_table():
    topo = build_topology(np.array([[0, 0, 0], [1, 0, 0]], np.int32))
    nbr = np.asarray(topo.nbr)
    id0 = int(lookup_tiles(topo, jnp.array([0, 0, 0], jnp.int32)))
    id1 = int(lookup_tiles(topo, jnp.array([1, 0, 0], jnp.int32)))
    center = 13  # (0+1)*9 + (0+1)*3 + (0+1)
    plus_x = (1 + 1) * 9 + 3 + 1
    minus_x = (-1 + 1) * 9 + 3 + 1
    assert nbr[id0, center] == id0
    assert nbr[id0, plus_x] == id1
    assert nbr[id1, minus_x] == id0
    assert nbr[id0, minus_x] == 0  # absent neighbor -> null tile
    assert np.all(nbr[0] == 0)  # null tile has no neighbors


def test_dense_box_and_dilate():
    topo = build_topology_dense((16, 16, 16))
    assert topo.n_active == 8
    grown = dilate_topology(topo)
    assert grown.n_active == 4 * 4 * 4  # 2^3 box -> 4^3 box of tiles


def test_voxel_positions_and_mask():
    topo = build_topology(np.array([[2, -1, 0]], np.int32))
    pos = np.asarray(voxel_positions(topo))
    assert pos.shape == (topo.capacity, 8, 8, 8, 3)
    np.testing.assert_array_equal(pos[1, 0, 0, 0], [16, -8, 0])
    np.testing.assert_array_equal(pos[1, 7, 7, 7], [23, -1, 7])
    m = np.asarray(active_mask(topo))
    assert m[0] == 0 and m[1] == 1 and np.all(m[2:] == 0)


def test_capacity_growth_is_static():
    topo = build_topology(np.zeros((1, 3), np.int32), capacity=64)
    assert topo.capacity == 64
    with pytest.raises(ValueError):
        build_topology(np.zeros((1, 3), np.int32), capacity=1)


def test_pytree_roundtrip():
    import jax

    topo = build_topology_dense((8, 8, 8))
    leaves, treedef = jax.tree_util.tree_flatten(topo)
    topo2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(topo2, Topology)
    assert topo2.n_active == topo.n_active


def test_large_capacity_policy_divisibility():
    """Above 2048 tiles, capacity uses 25% slack rounded to 2048 — and must
    stay divisible by the advection chunk."""
    from hnanosolver_tpu.core.topology import _round_capacity

    for n in (2100, 4196, 33656, 100000):
        cap = _round_capacity(n)
        assert cap >= n + 1
        assert cap % 2048 == 0
        assert cap <= (n + 1) * 1.25 + 2048
    # small counts stay power-of-two
    assert _round_capacity(5) == 16
    assert _round_capacity(1000) == 1024

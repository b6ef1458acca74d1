"""The port's distributed tier against the JAX package's (see
``torch_dist_parity``): ``dist_reduce_scalar`` (PLUS and MAX on
all-reduce, TIMES on the tree fold), ``dist_bfs_levels`` through the
sparse, the dense and the adaptive frontier exchange, ``dist_pagerank``;
and, against numpy, unsigned and bool values across the collectives."""

import functools

import numpy as np
import pytest
import scipy.sparse.csgraph as csg

from torch_dist_parity import (CASES, WORLD_IDS, WORLDS, assert_matches,
                               jax_spmv, port_result, spawn)

REDUCE = ["reduce_plus", "reduce_max", "reduce_times"]
BFS = ["bfs", "bfs_dense", "bfs_sparse"]
NUMPY = ["u64_mxv", "u64_vxm_min", "bool_vxm", "any_mxv", "any_vxm",
         "any_vxm_gap"]


@pytest.fixture(scope="module", params=WORLDS, ids=WORLD_IDS)
def world(request):
    return spawn(request.param,
                 [*REDUCE, "reduce_any", *BFS, "pagerank", *NUMPY])


@functools.lru_cache(maxsize=None)
def jax_ref(ndev, name):
    return jax_spmv(ndev, CASES[name])


@pytest.mark.parametrize("name", REDUCE)
def test_dist_reduce_matches_jax(world, name):
    ndev, _ = world
    got = port_result(world, name)
    assert got.shape == ()
    assert_matches(got, jax_ref(ndev, name), name == "reduce_max")


def test_dist_reduce_any_past_an_empty_shard(world):
    """ANY over negative values with rows 30-59 empty, so that at 3 and at
    8 ranks a whole shard holds no entry: the largest stored value (the
    empty rank offers the type's minimum to the MAX all-reduce, not ANY's
    identity 0).  The JAX tier pads every shard with the identity and
    gives 0, a value no entry holds (ROADMAP Queue 3)."""
    ndev, _ = world
    S = CASES["reduce_any"]["S"]
    got = port_result(world, "reduce_any")
    assert got.shape == () and got == S.data.max() < 0
    assert jax_ref(ndev, "reduce_any") == 0                # the reference's


def test_dist_vxm_any_past_an_empty_shard(world):
    """ANY vxm over negative products with a whole shard empty: every
    column with entries gets the largest of its products (the empty
    rank's partial holds the type's minimum, not 0)."""
    S, x = CASES["any_vxm_gap"]["S"], CASES["any_vxm_gap"]["x"]
    cols = np.bincount(S.indices, minlength=S.shape[1]) > 0
    want = np.full(S.shape[1], -np.inf)
    np.maximum.at(want, S.indices, x[_rows(S)])
    assert (want[cols] < 0).all()
    got = port_result(world, "any_vxm_gap")
    np.testing.assert_array_equal(got[cols], want[cols])


@pytest.mark.parametrize("name", BFS)
def test_dist_bfs_matches_jax(world, name):
    """Levels exact against the JAX tier and scipy, through the sparse
    exchange (cap 4096), the dense one (cap 1) and the adaptive default."""
    ndev, _ = world
    got = port_result(world, name)
    assert_matches(got, jax_ref(ndev, name), True)
    S = CASES[name]["S"].copy()
    S.data[:] = 1.0
    lv = csg.shortest_path(S, unweighted=True, indices=0)
    np.testing.assert_array_equal(
        got, np.where(np.isfinite(lv), lv, -1).astype(np.int32))


def test_dist_pagerank_matches_jax(world):
    ndev, _ = world
    assert_matches(port_result(world, "pagerank"),
                   jax_ref(ndev, "pagerank"), False)


def _rows(S):
    return np.repeat(np.arange(S.shape[0]), np.diff(S.indptr))


def test_uint64_mxv_wraps(world):
    """UINT64 plus-times: products and sums wrap modulo 2^64, as numpy's
    uint64 arithmetic."""
    S, x = CASES["u64_mxv"]["S"], CASES["u64_mxv"]["x"]
    with np.errstate(over="ignore"):
        prod = S.data * x[S.indices]
        want = np.zeros(S.shape[0], np.uint64)
        np.add.at(want, _rows(S), prod)
    assert (prod < S.data).any()                       # products wrap
    np.testing.assert_array_equal(port_result(world, "u64_mxv"), want)


def test_uint64_vxm_min_orders_across_2_63(world):
    """UINT64 min-plus vxm, combined across ranks by MIN on the carriers'
    order keys: values on both sides of 2^63 order as unsigned."""
    S, x = CASES["u64_vxm_min"]["S"], CASES["u64_vxm_min"]["x"]
    want = np.full(S.shape[1], np.iinfo(np.uint64).max, np.uint64)
    with np.errstate(over="ignore"):
        np.minimum.at(want, S.indices, x[_rows(S)] + S.data)
    got = port_result(world, "u64_vxm_min")
    top = np.uint64(1 << 63)
    assert (got > top).any() and (got < top).any()
    np.testing.assert_array_equal(got, want)


def test_bool_vxm_lor_land(world):
    """Bool crosses the collectives as uint8; LOR combines by MAX."""
    S, x = CASES["bool_vxm"]["S"], CASES["bool_vxm"]["x"]
    want = (S.T.astype(np.int64) @ x.astype(np.int64)) > 0
    np.testing.assert_array_equal(port_result(world, "bool_vxm"), want)


def test_any_takes_a_stored_value(world):
    """ANY over negative values: the port reduces ANY as a max from the
    type's minimum, so every row (mxv) and column (vxm) with entries gets
    one of its values (the largest).  The JAX tier does not (ROADMAP
    Queue 3): its dist_vxm scatters by max from the identity 0, and its
    dist_mxv pads each shard at its last row with the identity 0, so such
    rows and columns come out 0, a value no entry holds."""
    ndev, _ = world
    S = CASES["any_mxv"]["S"]
    rows = np.diff(S.indptr) > 0
    want = np.full(S.shape[0], -np.inf)
    np.maximum.at(want, _rows(S), S.data)
    got = port_result(world, "any_mxv")
    np.testing.assert_array_equal(got[rows], want[rows])
    x = CASES["any_vxm"]["x"]
    cols = np.bincount(S.indices, minlength=S.shape[1]) > 0
    wantv = np.full(S.shape[1], -np.inf)
    np.maximum.at(wantv, S.indices, x[_rows(S)])
    gotv = port_result(world, "any_vxm")
    np.testing.assert_array_equal(gotv[cols], wantv[cols])
    assert (wantv[cols] < 0).all()
    jv = jax_ref(ndev, "any_vxm")
    assert (jv[cols] == 0).all()                  # the reference's fault
    jm = jax_ref(ndev, "any_mxv")
    assert (jm[rows] == 0).any() and (want[rows] < 0).all()

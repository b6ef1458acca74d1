"""The port's distributed tier against the JAX package's (see
``torch_dist_parity``): the row-block partition, ``dist_mxv`` on each
local-SpMV tier (K2, K3, K1, K4 by predicate, here their plain versions;
fp64 min-plus and a positional multiply in torch), empty rows, and the
mesh over the whole world."""

import functools

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import parallel as jpar
import torch_dist_cases as PT
from torch_dist_parity import (CASES, WORLD_IDS, WORLDS, assert_matches,
                               exact, jax_spmv, port_result, spawn)

MXV = ["mxv_f64", *PT.SHARED_F32, "min_plus_f64", "firsti"]
# mxv_f32_planned is mxv_f32 again, once the shard has its plan
SAME_AS = {"mxv_f32_planned": "mxv_f32"}


@pytest.fixture(scope="module", params=WORLDS, ids=WORLD_IDS)
def world(request):
    return spawn(request.param, ["partition", "mesh_error", *MXV])


@functools.lru_cache(maxsize=None)
def jax_ref(ndev, name):
    name = SAME_AS.get(name, name)
    return jax_spmv(ndev, CASES[name])


def test_partition_matches_jax(world):
    """Each rank's shard arrays equal the JAX tier's at its index,
    padding and dtypes included."""
    ndev, res = world
    S = CASES["partition"]["S"]
    D = jpar.DistMatrix.from_matrix(gb.Matrix.from_scipy(S),
                                    jpar.make_mesh(ndev))
    want = [np.asarray(a) for a in (D.indptr, D.indices, D.values, D.nnz)]
    for r, out in enumerate(res):
        ip, ix, vl, nz = out["partition"]
        for got, w in zip((ip, ix, vl), want[:3]):
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w[r])
        assert nz == int(want[3][r])
    assert sum(out["partition"][3] for out in res) == S.nnz


@pytest.mark.parametrize("name", MXV)
def test_dist_mxv_matches_jax(world, name):
    ndev, _ = world
    assert_matches(port_result(world, name), jax_ref(ndev, name),
                   exact(CASES[name]))


def test_local_spmv_tiers(world):
    """The tier each local SpMV took: K2 before the shard has a plan, K3
    building it, then K1 and K4 on it; fp64 min-plus and the positional
    FIRSTI in torch."""
    tiers = world[1][0]["tiers"]
    assert tiers["mxv_f32"] == ["merge"]
    assert tiers["min_plus_f32"] == ["route_monoid min_plus"]
    assert tiers["max_second_f32"] == ["route_monoid max_second"]
    assert tiers["mxv_f32_planned"] == ["route"]
    assert tiers["mxv_f32_to_f64"] == ["route_ds"]
    assert tiers["mxv_f64"] == ["route_ds"]
    assert tiers["min_plus_f64"] == ["torch"]
    assert tiers["firsti"] == ["torch"]


def test_empty_rows_take_the_identity(world):
    """Rows with no entries come out +inf under min-plus from K3 (its
    plain version here) and -inf under max-second, as JAX's
    segment_reduce gives."""
    empty = np.diff(CASES["min_plus_f32"]["S"].indptr) == 0
    assert empty.any()
    assert np.all(port_result(world, "min_plus_f32")[empty] == np.inf)
    assert np.all(port_result(world, "max_second_f32")[empty] == -np.inf)


def test_mesh_takes_the_whole_world(world):
    """A mesh of fewer ranks than the world raises (the JAX tier takes a
    prefix of its devices; torch.distributed runs a process a rank)."""
    assert "the mesh takes the whole world" in world[1][0]["mesh_error"]

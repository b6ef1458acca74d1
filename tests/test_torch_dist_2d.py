"""The port's 2-D partition (``DistMatrix2D``, ``dist_mxv_2d``) against
the JAX package's (see ``torch_dist_parity``), on both grids of the world:
(2, 4) and (4, 2) of 8 ranks, (1, 3) and (3, 1) of 3."""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu.core as jcore
from graphblas_tpu import parallel as jpar
import torch_dist_cases as PT
from torch_dist_parity import (WORLD_IDS, WORLDS, assert_matches,
                               port_result, spawn)

MXV_2D = ["mxv_2d", "mxv_2d_min_plus", "mxv_2d_times", "mxv_2d_f32"]


@pytest.fixture(scope="module", params=WORLDS, ids=WORLD_IDS)
def world(request):
    return spawn(request.param, MXV_2D)


@pytest.mark.parametrize("name", MXV_2D)
def test_dist_mxv_2d_matches_jax(world, name):
    """(2, n/2) and (n/2, 2) grids of an even world, (1, 3) and (3, 1) of
    3 ranks: plus-times (fp64 and fp32: K4 and K2 tiers), min-plus and
    the TIMES monoid combined over the c axis."""
    ndev = world[0]
    case = PT.mxm_cases(ndev)[name]
    mesh = jpar.make_mesh_2d(*case["grid"])
    D2 = jpar.DistMatrix2D.from_matrix(gb.Matrix.from_scipy(case["S"]), mesh)
    want = np.asarray(jpar.dist_mxv_2d(D2, case["x"],
                                       PT.semiring(jcore, case["sr"])))
    assert_matches(port_result(world, name), want,
                   case["sr"][0] == "MIN")


def test_dist_mxv_2d_tiers(world):
    """Each block's local SpMV takes the 1-D tiers: fp64 and fp32
    plus-times on K4 and K2, min-plus fp64 and the TIMES monoid in
    torch."""
    tiers = world[1][0]["tiers"]
    assert tiers["mxv_2d"] == ["route_ds"]
    assert tiers["mxv_2d_f32"] == ["merge"]
    assert tiers["mxv_2d_min_plus"] == ["torch"]
    assert tiers["mxv_2d_times"] == ["torch"]

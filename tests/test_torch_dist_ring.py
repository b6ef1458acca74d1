"""The port's distributed tier against the JAX package's (see
``torch_dist_parity``): ``dist_mxv`` with mask / accum / complement, the
ring (``overlap=True``) against the JAX ring and the port's all-gather
path, ANY on the ring against numpy, and ``dist_vxm`` (PLUS, the TIMES
monoid's tree fold, mask and accum)."""

import functools

import numpy as np
import pytest

from torch_dist_parity import (CASES, WORLD_IDS, WORLDS, assert_matches,
                               jax_spmv, port_result, spawn)

MXV = ["mask_accum", "mask_complement", "ring_f64", "ring_int",
       "ring_min_plus", "ring_mask_accum"]
RING_ANY = ["ring_any_first", "ring_any_pair"]
RING = ["ring_f64", "ring_int", "ring_min_plus", "ring_mask_accum",
        *RING_ANY]
VXM = ["vxm", "vxm_times", "vxm_mask_accum"]


@pytest.fixture(scope="module", params=WORLDS, ids=WORLD_IDS)
def world(request):
    return spawn(request.param,
                 [*MXV, *RING_ANY, *(r + "_gather" for r in RING), *VXM])


@functools.lru_cache(maxsize=None)
def jax_ref(ndev, name):
    return jax_spmv(ndev, CASES[name])


@pytest.mark.parametrize("name", MXV)
def test_dist_mxv_matches_jax(world, name):
    ndev, _ = world
    assert_matches(port_result(world, name), jax_ref(ndev, name),
                   name in ("ring_int", "ring_min_plus"))


@pytest.mark.parametrize("name,exact", [("ring_int", True),
                                        ("ring_min_plus", True),
                                        ("ring_any_first", True),
                                        ("ring_any_pair", True),
                                        ("ring_f64", False),
                                        ("ring_mask_accum", False)])
def test_ring_matches_all_gather(world, name, exact):
    """The ring gives the all-gather path's result: bitwise on ints,
    min-plus (K3's plain version on the all-gather path) and ANY, within
    the fp64 tolerance on float sums."""
    assert_matches(port_result(world, name),
                   port_result(world, name + "_gather"), exact)


def test_ring_reduces_in_torch(world):
    """The ring's steps reduce in torch, never through a kernel tier."""
    tiers = world[1][0]["tiers"]
    assert all(tiers[r] == [] for r in RING)
    assert tiers["ring_min_plus_gather"] == ["route_monoid min_plus"]


@pytest.mark.parametrize("name", RING_ANY)
def test_ring_any_matches_numpy(world, name):
    """ANY on the ring folds its steps by the max that ``segment_reduce``
    reduces ANY with: every row with entries gets the largest of its
    products (negative fp64 values under ANY_FIRST; True under bool
    ANY_PAIR, the BFS semiring).  The JAX ring folds its steps with ANY's
    operator, which keeps the last step's rows only, so rows whose
    entries lie in earlier blocks lose them (ROADMAP Queue 3)."""
    ndev, _ = world
    S = CASES[name]["S"]
    has = np.diff(S.indptr) > 0
    got = port_result(world, name)
    if name == "ring_any_pair":
        np.testing.assert_array_equal(got, has)
    else:
        rows = np.repeat(np.arange(S.shape[0]), np.diff(S.indptr))
        want = np.full(S.shape[0], -np.inf)
        np.maximum.at(want, rows, S.data)
        assert (want[has] < 0).all()
        np.testing.assert_array_equal(got[has], want[has])
    assert (jax_ref(ndev, name)[has] != got[has]).any()   # the reference's


@pytest.mark.parametrize("name", VXM)
def test_dist_vxm_matches_jax(world, name):
    ndev, _ = world
    assert_matches(port_result(world, name), jax_ref(ndev, name), False)

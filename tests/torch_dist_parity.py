"""Helpers of the distributed tier's parity tests (tests/test_torch_dist*
.py): spawn the port's gloo ranks, run a case on the JAX tier over the
first ``ndev`` of the 8 CPU devices, and compare.

Each test file spawns its ranks once a world (8 and 3: with 3 the rows
split unevenly and the tree fold pads with the identity); every rank runs
the file's cases of ``torch_dist_cases`` and returns
its results.  Tolerances: exact for ints, bool, min/max and BFS levels;
1e-5 * max|y| for fp32 sums (a reduce-scatter orders its sums unlike
psum_scatter), 1e-12 * max|y| for fp64."""

import numpy as np

import graphblas_tpu as gb
import graphblas_tpu.core as jcore
from graphblas_tpu import parallel as jpar
from graphblas_tpu.core import names as _jnames  # noqa: F401
from graphblas_tpu_torch.parallel import launch
import torch_dist_cases as PT

WORLDS = (8, 3)
WORLD_IDS = ("world8", "world3")
CASES = PT.spmv_cases()


def spawn(ndev, names, **paths):
    """(ndev, every rank's results) of the cases ``names`` on ``ndev``
    gloo ranks."""
    return ndev, launch.spawn(PT.rank_main, ndev, "cpu", list(names),
                              paths.get("ckpt_out"), paths.get("ckpt_in"),
                              paths.get("ckpt_bad"), timeout_s=240)


def jax_spmv(ndev, case):
    """An mxv / vxm / reduce / BFS / PageRank case on the JAX tier."""
    mesh = jpar.make_mesh(ndev)
    D = jpar.DistMatrix.from_matrix(gb.Matrix.from_scipy(case["S"]), mesh)
    kw = dict(case.get("kw", {}))
    if "accum" in kw:
        kw["accum"] = getattr(jcore.ops, kw["accum"])
    op = case["op"]
    if op in ("mxv", "vxm"):
        fn = jpar.dist_mxv if op == "mxv" else jpar.dist_vxm
        out = fn(D, case["x"], PT.semiring(jcore, case["sr"]), **kw)
    elif op == "reduce":
        out = jpar.dist_reduce_scalar(D, getattr(jcore.monoid, case["mon"]))
    elif op == "bfs":
        out = jpar.dist_bfs_levels(D, case["source"], **kw)
    else:
        out = jpar.dist_pagerank(D, **kw)
    return np.asarray(out)


def port_result(world, name):
    """The case's result on rank 0, after checking that every rank holds
    the same bits (results come back whole on every rank)."""
    _, res = world
    got = res[0][name]
    for r in res[1:]:
        np.testing.assert_array_equal(r[name], got)
    return got


def assert_matches(got, want, exact):
    """Same dtype and shape; exact, or within 1e-5 (fp32) / 1e-12 (fp64)
    of max|want| with infinities in the same places."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    tol = 1e-5 if got.dtype == np.float32 else 1e-12
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = float(np.abs(want[fin]).max(initial=0.0))
    err = float(np.abs(got[fin].astype(np.float64) - want[fin]).max(
        initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def exact(case):
    """Min/max add monoids (and ints, by dtype) compare exactly."""
    sr = case.get("sr")
    return isinstance(sr, tuple) and sr[0] in ("MIN", "MAX")

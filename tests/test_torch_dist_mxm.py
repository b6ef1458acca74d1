"""The port's distributed tier against the JAX package's (see
``torch_dist_parity``): ``dist_mxm`` (block-row SUMMA on the port's own
mxm; a hub row; min-plus), sharded checkpoints written by either package
and loaded by the other, and ``dryrun_multichip`` on 4 gloo ranks."""

import json
import time

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu.core as jcore
from graphblas_tpu import parallel as jpar
from graphblas_tpu_torch.entry import dryrun_multichip
from graphblas_tpu_torch.parallel import dist as P
from graphblas_tpu_torch.parallel import launch
import torch_dist_cases as PT
from torch_dist_parity import (WORLD_IDS, WORLDS, assert_matches,
                               port_result, spawn)

MXM = ["mxm", "mxm_self", "mxm_hub", "mxm_min_plus_f32", "mxm_f32"]
CKPT = PT.mxm_cases(8)["ckpt"]["S"]


@pytest.fixture(scope="module", params=WORLDS, ids=WORLD_IDS)
def world(request, tmp_path_factory):
    """The ranks, after the JAX tier wrote a checkpoint of the world's
    size (``ckpt_in``) and one of 2 shards (``ckpt_bad``)."""
    ndev = request.param
    tmp = tmp_path_factory.mktemp(f"dist{ndev}")
    for name, n in (("ckpt_in", ndev), ("ckpt_bad", 2)):
        jpar.save_sharded(jax_matrix(CKPT, n), tmp / name)
    w = spawn(ndev, [*MXM, "ckpt", "ckpt_in", "ckpt_bad"],
              ckpt_out=str(tmp / "ckpt_out"), ckpt_in=str(tmp / "ckpt_in"),
              ckpt_bad=str(tmp / "ckpt_bad"))
    return w + (tmp,)


def jax_matrix(S, ndev):
    return jpar.DistMatrix.from_matrix(gb.Matrix.from_scipy(S),
                                       jpar.make_mesh(ndev))


def jax_arrays(D):
    return [np.asarray(a) for a in (D.indptr, D.indices, D.values, D.nnz)]


@pytest.mark.parametrize("name", MXM)
def test_dist_mxm_matches_jax(world, name):
    """Each rank's output shard has JAX's indptr, nnz, column ids (in
    order) and values (1e-12 * max|v| for fp64 sums, exact for min-plus);
    only the padding past nnz differs (the port pads to the largest
    shard's nnz, JAX to a flop bound)."""
    ndev, res = world[:2]
    case = PT.mxm_cases(ndev)[name]
    DA = jax_matrix(case["S"], ndev)
    DB = DA if case["B"] is None else jax_matrix(case["B"], ndev)
    ip, ix, vl, nz = jax_arrays(jpar.dist_mxm(
        DA, DB, PT.semiring(jcore, case["sr"])))
    cap = max(int(nz.max()), 1)
    for r, out in enumerate(res):
        gip, gix, gvl, gnz = out[name]
        assert gnz == int(nz[r]) and gix.size == gvl.size == cap
        np.testing.assert_array_equal(gip, ip[r])
        np.testing.assert_array_equal(gix[:gnz], ix[r][:gnz])
        assert_matches(gvl[:gnz], vl[r][:gnz], case["sr"][0] == "MIN")
        np.testing.assert_array_equal(gix[gnz:], 0)
        np.testing.assert_array_equal(gvl[gnz:], 0)


def test_dist_mxm_matches_scipy(world):
    """The hub-row product reassembled from every rank's shard equals
    scipy's A @ B."""
    ndev, res = world[:2]
    case = PT.mxm_cases(ndev)["mxm_hub"]
    n = case["S"].shape[0]
    rp = -(-n // ndev)
    got = np.zeros((n, n))
    for r, out in enumerate(res):
        ip, ix, vl, nz = out["mxm_hub"]
        rows = np.repeat(np.arange(ip.size - 1), np.diff(ip))
        got[r * rp + rows[:nz], ix[:nz]] = vl[:nz]
    want = (case["S"] @ case["B"]).toarray()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_checkpoint_port_to_jax(world):
    """The port's checkpoint holds the JAX package's files: the same
    manifest, and shards the JAX tier loads to its own partition's
    arrays."""
    ndev, res, tmp = world
    out = tmp / "ckpt_out"
    want = jax_arrays(jax_matrix(CKPT, ndev))
    assert json.loads((out / "manifest.json").read_text()) == \
        json.loads((tmp / "ckpt_in" / "manifest.json").read_text())
    back = jax_arrays(jpar.load_sharded(out, jpar.make_mesh(ndev)))
    for got, w in zip(back, want):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    for r, o in enumerate(res):                 # the port's reload too
        for got, w in zip(o["ckpt"], want):
            np.testing.assert_array_equal(got, w[r])


def test_checkpoint_jax_to_port(world):
    """The JAX package's checkpoint loads in the port to the same shard
    arrays, and computes: dist_mxv of ones against scipy."""
    ndev, res = world[:2]
    want = jax_arrays(jax_matrix(CKPT, ndev))
    for r, o in enumerate(res):
        ip, ix, vl, nz = o["ckpt_in"]
        for got, w in zip((ip, ix, vl), want):
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w[r])
        assert nz == int(want[3][r])
    assert_matches(port_result(world[:2], "ckpt_in_mxv"),
                   (CKPT @ np.ones(CKPT.shape[1], np.float32)
                    ).astype(np.float32), False)


def test_checkpoint_of_another_world_raises(world):
    assert "holds 2 shards" in world[1][0]["ckpt_bad"]


def test_dryrun_multichip_on_gloo():
    dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_needs_the_card():
    """Without ``device`` the ranks take the cards: here there are none,
    so it raises rather than land on the CPU."""
    with pytest.raises((RuntimeError, ValueError)):
        dryrun_multichip(2)


def test_spawn_stops_every_rank_when_one_fails():
    """Rank 1 raises while rank 0 waits on it in an all-reduce: spawn
    terminates rank 0 at once and raises with rank 1's traceback."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        launch.spawn(PT.rank_fails, 2, "cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_spawn_terminates_ranks_past_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch.spawn(PT.rank_sleeps, 2, "cpu", 600, timeout_s=8)
    assert time.monotonic() - t0 < 60


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        P.make_mesh(1)

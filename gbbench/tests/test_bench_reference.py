"""The references against scipy, and the lower-precision control against
the limits, at a size a test run holds."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csg
import torch

from gbbench import catalog, graph


def edges_of(name, seed=7, scale=10):
    cfg = catalog.load_json(catalog.HERE / "configs" / f"{name}.json")
    return cfg, graph.generate(cfg, seed, "cpu", scale)


def min_matrix(e):
    """scipy CSR of both directions, duplicates merged by min."""
    r = np.concatenate([e.src.numpy(), e.dst.numpy()]).astype(np.int64)
    c = np.concatenate([e.dst.numpy(), e.src.numpy()]).astype(np.int64)
    w = np.concatenate([e.w.numpy(), e.w.numpy()]).astype(np.float64)
    key = r * e.n + c
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    first = np.ones(key.size, bool)
    first[1:] = key[1:] != key[:-1]
    return sps.csr_matrix((w[first], (key[first] // e.n, key[first] % e.n)),
                          shape=(e.n, e.n))


@pytest.mark.parametrize("name", ["graph500-kron", "gap-urand"])
def test_sssp_matches_dijkstra(name):
    cfg, e = edges_of(name)
    ref = catalog.module("reference", "sssp")
    state = ref.prepare(e, cfg, {}, torch.float64)
    S = min_matrix(e)
    for root in (0, int(e.src[5]), int(e.dst[99])):
        got = ref.solve(state, root, {}, torch.float64).numpy()
        want = csg.dijkstra(S, indices=root)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert np.allclose(got[fin], want[fin], rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["graph500-kron", "gap-urand"])
def test_pagerank_matches_power_iteration(name):
    cfg, e = edges_of(name)
    ref = catalog.module("reference", "pagerank")
    params = {"damping": 0.85, "tol": 1e-4, "max_iter": 20}
    got = ref.solve(ref.prepare(e, cfg, params, torch.float64), None,
                    params, torch.float64).numpy()
    S = min_matrix(e)
    S.data[:] = 1.0
    n = e.n
    deg = np.asarray(S.sum(axis=1)).ravel()
    sdeg = np.where(deg > 0, deg, 1.0)
    r = np.full(n, 1.0 / n)
    for _ in range(20):
        rn = 0.85 * (S.T @ (r / sdeg) + r[deg == 0].sum() / n) + 0.15 / n
        delta = np.abs(rn - r).sum()
        r = rn
        if delta <= 1e-4:
            break
    assert np.allclose(got, r, rtol=1e-12, atol=0)


@pytest.mark.parametrize("workload", ["kron.sssp", "urand.pr", "kron.pr"])
def test_control_fails_and_program_passes(workload):
    """The reference computed in bfloat16 in the program's place comes out
    not correct under the cell's limits; the program comes out correct.
    (urand.sssp's control is held on the card at its own size,
    ``test_bench_cuda``: GAP's integer weights give integer distances,
    which bfloat16 holds exactly below 256, and at a size a CPU run holds
    no distance reaches 256.)"""
    import time

    from gbbench import run
    cell = catalog.cell(workload)
    res = run.run_cell(cell, 2**31 + 99, 0.2, False, "cpu",
                       time.perf_counter(), scale=11, log=lambda s: None,
                       control=[torch.bfloat16])
    assert res["correct"]
    assert res["controls"]["bfloat16"]["correct"] is False
    lim = cell.traffic["limits"]["max_rel_gap"]
    assert res["checks"]["max_rel_gap"]["value"] < lim
    assert res["controls"]["bfloat16"]["checks"]["max_rel_gap"]["value"] \
        > 10 * lim

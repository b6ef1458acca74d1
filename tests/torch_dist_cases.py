"""Cases for holding the distributed tier against the JAX package's
(``test_torch_dist*.py``) on gloo ranks, and on the card
(``test_torch_cuda.py``).

A case is a dict of inputs made with numpy from a fixed seed (so the
spawned ranks and the test process build the same ones) and of what to
call: ``op`` names the distributed function, ``sr`` the semiring as
(monoid, multiply) attribute names of ``core.monoid`` / ``core.ops`` or
a predefined name, ``kw`` its keyword arguments.  ``run_port`` runs a
case on the port inside a rank; the tests run the same case on the JAX
package.  The ranks are spawned processes that import this module by
name (the spawn start method hands them the test process's sys.path),
so it imports no JAX, and ``rank_main`` checks that none was loaded.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as dist

from graphblas_tpu_torch import Matrix, core
from graphblas_tpu_torch.core import config as CFG
from graphblas_tpu_torch.core import names as _names  # noqa: F401
from graphblas_tpu_torch.core import types as T
from graphblas_tpu_torch.parallel import dist as P


def random_graph(seed, n, avg_deg=5, directed=True, dtype=np.float64,
                 empty_every=0, pattern=False):
    """n x n, ~avg_deg random off-diagonal entries a row, standard normal
    values (1 with ``pattern``); rows i % empty_every == 0 emptied."""
    rng = np.random.default_rng(seed)
    nnz = n * avg_deg
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    keep = r != c
    S = sps.csr_matrix((rng.standard_normal(int(keep.sum())),
                        (r[keep], c[keep])), shape=(n, n))
    if not directed:
        S = S + S.T
    S.sum_duplicates()
    if empty_every:
        S = sps.diags((np.arange(n) % empty_every != 0).astype(float)) @ S
        S.eliminate_zeros()
    if pattern:
        S.data[:] = 1.0
    S = S.astype(dtype).tocsr()
    S.sort_indices()
    return S


def _vec(seed, n, dtype=np.float64, positive=False):
    v = np.random.default_rng(seed).standard_normal(n)
    return (np.abs(v) if positive else v).astype(dtype)


def _abs(S):
    S = S.copy()
    S.data = np.abs(S.data)
    return S


def _near_one(S, seed):
    S = S.copy()
    S.data = (1.0 + 0.01 * np.random.default_rng(seed).standard_normal(
        S.nnz)).astype(S.dtype)
    return S


def _ints(S, seed, dtype=np.int64):
    S = S.copy()
    S.data = np.random.default_rng(seed).integers(
        -5, 6, S.nnz).astype(dtype)
    S.data[S.data == 0] = 1
    return S


def _u64(S, seed):
    """UINT64 values on both sides of 2^63 (products and sums wrap)."""
    rng = np.random.default_rng(seed)
    S = sps.csr_matrix((rng.integers(1, 1 << 62, S.nnz, dtype=np.uint64)
                        * np.uint64(3), S.indices, S.indptr), shape=S.shape)
    return S


def spmv_cases():
    """The mxv / vxm / reduce / BFS / PageRank cases (world-independent)."""
    g3 = _abs(random_graph(3, 130, dtype=np.float32, empty_every=7))
    x3 = _vec(103, 130, np.float32, positive=True)
    g6 = random_graph(6, 100)
    m6 = np.random.default_rng(106).random(100) < 0.5
    g11 = random_graph(11, 90)
    m11 = np.random.default_rng(111).random(90) < 0.4
    g16 = random_graph(16, 96)
    m16 = np.random.default_rng(116).integers(0, 2, 96).astype(bool)
    u = _u64(random_graph(17, 80), 117)
    xu = np.random.default_rng(217).integers(1 << 62, 1 << 64, 80,
                                             dtype=np.uint64)
    gb = random_graph(18, 70, pattern=True).astype(bool)
    xb = np.random.default_rng(118).random(70) < 0.3
    neg = _abs(random_graph(19, 90, avg_deg=3))
    neg.data = -neg.data
    gap = sps.vstack([neg[:30], sps.csr_matrix((30, 90)), neg[60:]]).tocsr()
    return {
        "partition": dict(op="partition", S=random_graph(1, 100)),
        "mxv_f64": dict(op="mxv", S=random_graph(2, 120),
                        x=_vec(102, 120), sr=("PLUS", "TIMES")),
        # one DistMatrix in order: K2, K3 (builds the plan), K3, K1, K4
        "mxv_f32": dict(op="mxv", S=g3, x=x3, sr=("PLUS", "TIMES")),
        "min_plus_f32": dict(op="mxv", S=g3, x=x3, sr=("MIN", "PLUS")),
        "max_second_f32": dict(op="mxv", S=g3, x=x3, sr=("MAX", "SECOND")),
        "mxv_f32_planned": dict(op="mxv", S=g3, x=x3, sr=("PLUS", "TIMES")),
        "mxv_f32_to_f64": dict(op="mxv", S=g3, x=x3.astype(np.float64),
                               sr=("PLUS", "TIMES")),
        "min_plus_f64": dict(op="mxv", S=_abs(random_graph(4, 60)),
                             x=_vec(104, 60, positive=True),
                             sr=("MIN", "PLUS")),
        "firsti": dict(op="mxv", S=random_graph(5, 80, empty_every=9),
                       x=np.ones(80), sr="GxB_MIN_FIRSTI_INT32",
                       kw=dict(out_dtype=np.int32)),
        "mask_accum": dict(op="mxv", S=g6, x=_vec(206, 100),
                           sr=("PLUS", "TIMES"),
                           kw=dict(mask=m6, accum="PLUS", c=_vec(306, 100))),
        "mask_complement": dict(op="mxv", S=g6, x=_vec(206, 100),
                                sr=("PLUS", "TIMES"),
                                kw=dict(mask=m6, c=_vec(306, 100),
                                        mask_complement=True)),
        "ring_f64": dict(op="mxv", S=random_graph(7, 130), x=_vec(107, 130),
                         sr=("PLUS", "TIMES"), kw=dict(overlap=True)),
        "ring_int": dict(op="mxv", S=_ints(random_graph(8, 110), 108),
                         x=np.random.default_rng(208).integers(-9, 10, 110),
                         sr=("PLUS", "TIMES"), kw=dict(overlap=True)),
        "ring_min_plus": dict(op="mxv",
                              S=_abs(random_graph(9, 60, dtype=np.float32)),
                              x=_vec(109, 60, np.float32, positive=True),
                              sr=("MIN", "PLUS"), kw=dict(overlap=True)),
        "ring_mask_accum": dict(op="mxv", S=g16, x=_vec(216, 96),
                                sr=("PLUS", "TIMES"),
                                kw=dict(mask=m16, accum="PLUS",
                                        c=_vec(316, 96), overlap=True)),
        "vxm": dict(op="vxm", S=random_graph(10, 90), x=_vec(110, 90),
                    sr=("PLUS", "TIMES")),
        "vxm_times": dict(op="vxm", S=_near_one(random_graph(12, 64), 112),
                          x=1.0 + 0.01 * _vec(212, 64), sr=("TIMES", "PLUS")),
        "vxm_mask_accum": dict(op="vxm", S=g11, x=_vec(211, 90),
                               sr=("PLUS", "TIMES"),
                               kw=dict(mask=m11, accum="PLUS",
                                       c=_vec(311, 90))),
        "reduce_plus": dict(op="reduce", S=random_graph(13, 70), mon="PLUS"),
        "reduce_max": dict(op="reduce", S=random_graph(13, 70), mon="MAX"),
        "reduce_times": dict(op="reduce",
                             S=_near_one(random_graph(14, 70), 114),
                             mon="TIMES"),
        "bfs": dict(op="bfs", S=random_graph(19, 100, avg_deg=4,
                                             directed=False, pattern=True),
                    source=0),
        "bfs_dense": dict(op="bfs", S=random_graph(20, 150, avg_deg=3),
                          source=0, kw=dict(frontier_cap=1)),
        "bfs_sparse": dict(op="bfs", S=random_graph(20, 150, avg_deg=3),
                           source=0, kw=dict(frontier_cap=4096)),
        "pagerank": dict(op="pagerank", S=random_graph(21, 96, pattern=True),
                         kw=dict(tol=1e-10, max_iter=200)),
        # numpy references only (the JAX tier has no unsigned collectives)
        "u64_mxv": dict(op="mxv", S=u, x=xu, sr=("PLUS", "TIMES")),
        "u64_vxm_min": dict(op="vxm", S=u, x=xu, sr=("MIN", "PLUS")),
        "bool_vxm": dict(op="vxm", S=gb, x=xb, sr=("LOR", "LAND")),
        # ANY over negative values (a reference fault: ROADMAP Queue 3)
        "any_mxv": dict(op="mxv", S=neg, x=np.ones(90), sr=("ANY", "FIRST")),
        "any_vxm": dict(op="vxm", S=neg, x=-np.abs(_vec(119, 90)),
                        sr=("ANY", "FIRST")),
        # ANY on the ring (another reference fault): negative values (rows
        # 30-59 empty: at 3 and 8 ranks a whole shard has no entry), and
        # bool ANY_PAIR, the BFS semiring
        "ring_any_first": dict(op="mxv", S=gap, x=np.ones(90),
                               sr=("ANY", "FIRST"), kw=dict(overlap=True)),
        "ring_any_pair": dict(op="mxv", S=gb, x=xb, sr=("ANY", "PAIR"),
                              kw=dict(overlap=True)),
        # ANY over negative values past the empty shard (a third
        # reference fault), and its vxm
        "reduce_any": dict(op="reduce", S=gap, mon="ANY"),
        "any_vxm_gap": dict(op="vxm", S=gap, x=-np.abs(_vec(119, 90)),
                            sr=("ANY", "FIRST")),
    }


def mxm_cases(world):
    """dist_mxm, checkpoint and 2-D cases; the 2-D meshes fit ``world``."""
    def rnd(n, density, seed, dtype=np.float64):
        return sps.random(n, n, density=density, format="csr",
                          random_state=np.random.RandomState(seed),
                          dtype=dtype)
    hub = rnd(96, 0.05, 3).tolil()
    hub[5, :] = 1.0
    grids = ((2, world // 2), (world // 2, 2)) if world % 2 == 0 else \
        ((1, world), (world, 1))
    (a, b), (c, d) = grids
    return {
        "mxm": dict(op="mxm", S=rnd(96, 0.08, 1), B=rnd(96, 0.08, 2),
                    sr=("PLUS", "TIMES")),
        "mxm_self": dict(op="mxm", S=rnd(64, 0.08, 3), B=None,
                         sr=("PLUS", "TIMES")),
        "mxm_hub": dict(op="mxm", S=hub.tocsr(), B=rnd(96, 0.08, 4),
                        sr=("PLUS", "TIMES")),
        "mxm_min_plus_f32": dict(op="mxm", S=rnd(80, 0.1, 5, np.float32),
                                 B=None, sr=("MIN", "PLUS")),
        "mxm_f32": dict(op="mxm", S=rnd(96, 0.08, 6, np.float32),
                        B=rnd(96, 0.08, 7, np.float32),
                        sr=("PLUS", "TIMES")),
        "ckpt": dict(op="ckpt", S=rnd(64, 0.1, 3, np.float32)),
        "mxv_2d": dict(op="mxv_2d", S=rnd(100, 0.08, 4), x=_vec(401, 100),
                       sr=("PLUS", "TIMES"), grid=(a, b)),
        "mxv_2d_min_plus": dict(op="mxv_2d", S=_abs(rnd(60, 0.1, 8)),
                                x=_vec(408, 60, positive=True),
                                sr=("MIN", "PLUS"), grid=(c, d)),
        "mxv_2d_times": dict(op="mxv_2d",
                             S=_near_one(random_graph(22, 48), 122),
                             x=1.0 + 0.01 * _vec(422, 48),
                             sr=("TIMES", "PLUS"), grid=(c, d)),
        "mxv_2d_f32": dict(op="mxv_2d",
                           S=random_graph(23, 100, dtype=np.float32),
                           x=_vec(423, 100, np.float32),
                           sr=("PLUS", "TIMES"), grid=(a, b)),
    }


def semiring(pkg, spec):
    """The semiring ``spec`` names, from package ``pkg``'s core modules
    (the port's or the JAX package's)."""
    if isinstance(spec, str):
        return pkg.names.lookup(spec)
    mon, op = spec
    return pkg.semiring.Semiring(getattr(pkg.monoid, mon),
                                 getattr(pkg.ops, op))


def _host(t):
    return T.bits(t).cpu().numpy().view(T.lookup(t.dtype).np_dtype)


def shard_arrays(D):
    """A DistMatrix's shard as numpy (indptr, indices, values, nnz)."""
    return (_host(D.indptr), _host(D.indices), _host(D.values), D.nnz)


def run_port(case, mesh, device, ckpt=None):
    """One case on the port's distributed tier in this rank."""
    kw = dict(case.get("kw", {}))
    if "accum" in kw:
        kw["accum"] = getattr(core.ops, kw["accum"])
    op = case["op"]
    if op == "mxv_2d":
        D2 = P.DistMatrix2D.from_matrix(
            Matrix.from_scipy(case["S"], device=device), mesh)
        return _host(P.dist_mxv_2d(D2, case["x"],
                                   semiring(core, case["sr"])))
    D = case["D"] if "D" in case else P.DistMatrix.from_matrix(
        Matrix.from_scipy(case["S"], device=device), mesh)
    if op == "partition":
        return shard_arrays(D)
    if op in ("mxv", "vxm"):
        fn = P.dist_mxv if op == "mxv" else P.dist_vxm
        return _host(fn(D, case["x"], semiring(core, case["sr"]), **kw))
    if op == "reduce":
        return _host(P.dist_reduce_scalar(D, getattr(core.monoid,
                                                     case["mon"])))
    if op == "bfs":
        return _host(P.dist_bfs_levels(D, case["source"], **kw))
    if op == "pagerank":
        return _host(P.dist_pagerank(D, **kw))
    if op == "mxm":
        B = D if case["B"] is None else P.DistMatrix.from_matrix(
            Matrix.from_scipy(case["B"], device=device), mesh)
        return shard_arrays(P.dist_mxm(D, B, semiring(core, case["sr"])))
    if op == "ckpt":
        P.save_sharded(D, ckpt)
        back = P.load_sharded(ckpt, mesh)
        return shard_arrays(back)
    raise ValueError(op)


SHARED_F32 = ("mxv_f32", "min_plus_f32", "max_second_f32",
              "mxv_f32_planned", "mxv_f32_to_f64")


def rank_main(rank, world_size, device, names, ckpt_out=None, ckpt_in=None,
              ckpt_bad=None):
    """A spawned rank: the cases ``names`` on the port, in order, results
    as numpy by name, and the kernel tier each mxv took (``"tiers"``).
    The ``SHARED_F32`` cases run on one DistMatrix (the first builds no
    plan, the min-plus one builds it).  Besides the cases of
    ``spmv_cases`` and ``mxm_cases``: "<ring case>_gather" runs a ring
    case on the all-gather path; "mesh_error" makes a mesh smaller than
    the world (the message it raises); "ckpt" writes to ``ckpt_out`` and
    loads it back; "ckpt_in" loads the JAX package's checkpoint
    ``ckpt_in`` (its shard arrays and a dist_mxv of ones); "ckpt_bad"
    loads one of another world size (the message it raises)."""
    assert "jax" not in sys.modules, "a rank imported jax"
    mesh = P.make_mesh(world_size)
    cases = {**spmv_cases(), **mxm_cases(world_size)}
    out = {"tiers": {}}
    msgs = []
    old = CFG.get_option("printf"), CFG.get_option("burble")
    CFG.set_option("printf", msgs.append)
    CFG.set_option("burble", True)
    try:
        _run_cases(names, cases, mesh, device, out, msgs, ckpt_out, ckpt_in,
                   ckpt_bad)
    finally:
        CFG.set_option("printf", old[0])
        CFG.set_option("burble", old[1])
    assert "jax" not in sys.modules, "a rank imported jax"
    return out


def _run_cases(names, cases, mesh, device, out, msgs, ckpt_out, ckpt_in,
               ckpt_bad):
    """rank_main's loop: each case's result (and its tiers) into ``out``."""
    world_size = mesh.size()
    shared = None
    for name in names:
        msgs.clear()
        if name == "mesh_error":
            try:
                P.make_mesh(world_size - 1)
            except ValueError as e:
                out[name] = str(e)
        elif name == "ckpt_in":
            D = P.load_sharded(ckpt_in, mesh)
            out[name] = shard_arrays(D)
            out["ckpt_in_mxv"] = _host(P.dist_mxv(
                D, np.ones(D.shape[1], np.float32)))
        elif name == "ckpt_bad":
            try:
                P.load_sharded(ckpt_bad, mesh)
            except ValueError as e:
                out[name] = str(e)
        elif name.endswith("_gather"):
            case = cases[name[:-len("_gather")]]
            flat = dict(case, kw={k: v for k, v in case["kw"].items()
                                  if k != "overlap"})
            out[name] = run_port(flat, mesh, device)
        else:
            case = cases[name]
            if name in SHARED_F32:
                if shared is None:
                    shared = P.DistMatrix.from_matrix(
                        Matrix.from_scipy(case["S"], device=device), mesh)
                case = dict(case, D=shared)
            m = P.make_mesh_2d(*case["grid"]) if case["op"] == "mxv_2d" \
                else mesh
            out[name] = run_port(case, m, device, ckpt=ckpt_out)
        out["tiers"][name] = [t.split("tier=")[1] for t in msgs
                              if "spmv: tier=" in t]


def rank_fails(rank, world_size, device):
    """A rank body whose rank 1 raises while rank 0 waits on it in a
    collective (``launch.spawn`` must stop both and report rank 1)."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.ones(1))
    return rank


def rank_sleeps(rank, world_size, device, seconds):
    """A rank body that outlives a short ``spawn`` deadline."""
    time.sleep(seconds)
    return rank

"""Inputs and comparisons for holding the sort-reduce kernels (K5-K8,
kernels/sortreduce.py) against their plain versions, operands for the
fast SpGEMM tier's full-row edge case, misaligned copies of the SpMV
kernels' operands, and the RMAT graph generator of the benchmarks.  Used
by chip_smoke.py and the tests, among them tests/test_torch_cuda.py;
nothing here launches a kernel."""

from __future__ import annotations

import numpy as np
import torch

from .kernels.sortreduce import SENTINEL

FP32_TOL = 1e-5   # fp32 plus totals: the order of the sum differs


def rmat_edges(scale, edge_factor, rng, a=0.57, b=0.19, c=0.19):
    """Graph500 RMAT edges (a/b/c/d = 0.57/0.19/0.19/0.05): one quadrant
    draw per bit level for all edges, then a random relabelling of the
    vertices.  Returns (rows, cols, n) with duplicates and self loops
    kept; the same draws from ``rng`` as bench_real.py's generator."""
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, np.int64)
    cols = np.zeros(ne, np.int64)
    ab, abc = a + b, a + b + c
    for lvl in range(scale):
        r = rng.random(ne)
        right = (r >= a) & (r < ab)          # column bit set
        down = (r >= ab) & (r < abc)         # row bit set
        both = r >= abc
        rows |= (down | both).astype(np.int64) << lvl
        cols |= (right | both).astype(np.int64) << lvl
    perm = rng.permutation(n)
    return perm[rows], perm[cols], n


def shifted(t, by):
    """``t`` as a contiguous view ``by`` elements into a fresh buffer: its
    16-byte alignment moves by ``by`` elements (the SpMV kernels' 16-byte
    loads start where their operands reach it)."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    out = buf[by:]
    out.copy_(t)
    return out


def full_row_operands(C, rng, m=64, n=400):
    """Operands of a product whose last row holds exactly C products and
    ends in A entries whose B rows are empty: zero-length runs at the end
    of a full row of the fast SpGEMM tier's class C, the class's last row.
    Returns COO triples (rows, cols, f32 values, shape) of A (m x n), B
    (n x n; rows 300 and up empty) and a mask (random, its last row
    empty, so that row's load stays C)."""
    lens = [min(n, C - k * n) for k in range(-(-C // n))]
    lens += list(rng.integers(1, 9, 300 - len(lens)))
    b_rows = np.repeat(np.arange(300), lens)
    b_cols = np.concatenate([rng.choice(n, L, replace=False) for L in lens])
    a_rows = np.repeat(np.arange(m - 1), rng.integers(1, 7, m - 1))
    a_cols = np.concatenate([
        np.concatenate([rng.choice(n, c, replace=False) for c in
                        np.bincount(a_rows, minlength=m - 1)]),
        np.arange(-(-C // n)), np.arange(300, 310)])
    a_rows = np.concatenate([a_rows, np.full(a_cols.size - a_rows.size,
                                             m - 1)])
    k = int(m * n * 0.05)
    mk = rng.integers(0, m - 1, k), rng.integers(0, n, k)
    f = lambda r, c, s: (r, c, rng.standard_normal(r.size)  # noqa: E731
                         .astype(np.float32), s)
    return f(a_rows, a_cols, (m, n)), f(b_rows, b_cols, (n, n)), \
        (*mk, np.ones(k, np.float32), (m, n))


def sr_runs(rng, C, runs=64, hi=40):
    """int32 keys of ``runs`` C-slot runs: run 0 empty (all SENTINEL), run
    1 full, run 2 one key repeated, the rest partly filled, keys in
    [0, hi) with many duplicates, shuffled within each run."""
    k = np.full((runs, C), SENTINEL, np.int64)
    for r in range(1, runs):
        L = C if r in (1, 2) else int(rng.integers(1, C))
        k[r, :L] = 7 if r == 2 else rng.integers(0, hi, L)
        rng.shuffle(k[r])
    return k.reshape(-1).astype(np.int32)


def sr_edge_runs(rng, C=32768):
    """int32 keys of C-slot runs (C = 32768 by default, the cluster
    kernel's; any multiple of 8192 works) at the edges of its layout, each
    run shuffled unless said otherwise:
      0. group boundaries exactly at multiples of 8 (a thread's slots),
         256 (a warp's) and 8192 (a block's) in the sorted run;
      1. one group over sorted slots [9000, 25000): it spans three of the
         four blocks;
      2. all keys distinct: a permutation of [0, C);
      3. descending keys (groups of 3), not shuffled;
      4. keys 2^31 - 2 (100 of them) beside SENTINEL pads and large keys;
      5. SENTINEL everywhere but the last slot (not shuffled)."""
    q = C // 4
    s = np.arange(C, dtype=np.int64)
    bounds = np.where(s < q // 4, s // 8,
                      np.where(s < 2 * q, 4096 + s // 256, 65536 + s // q))
    span = np.concatenate([rng.integers(0, 9, 9000), np.full(16000, 9),
                           rng.integers(10, 100, C - 25000)])
    big = np.full(C, SENTINEL, np.int64)
    big[:100] = SENTINEL - 1
    big[100:20000] = rng.integers(1 << 30, SENTINEL - 1, 19900)
    last = np.full(C, SENTINEL, np.int64)
    last[-1] = 12345
    runs = [bounds, span, rng.permutation(C), (C - 1 - s) // 3, big, last]
    for r in (0, 1, 4):
        rng.shuffle(runs[r])
    return np.concatenate(runs).astype(np.int32)


def sr_values(rng, n, kind):
    """``n`` values: f32 normal, bool carried as 0/1 int32, or small
    int32."""
    if kind == "f32":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "bool":
        return (rng.random(n) < 0.5).astype(np.int32)
    return rng.integers(-50, 50, n).astype(np.int32)


def sr_tokens(rng, keys, C):
    """Token plane for ``keys``: 1 = mask entry (at most one per key and
    run), 2 = product, 0 at SENTINEL slots."""
    t = np.where(keys == SENTINEL, 0, 2).astype(np.int32)
    for r in range(keys.size // C):
        u, first = np.unique(keys[r * C:(r + 1) * C], return_index=True)
        pick = (u != SENTINEL) & (rng.random(u.size) < 0.5)
        t[r * C + first[pick]] = 1
    return t


def sr_wide_keys(rng, C, runs=64):
    """Two key planes (rank, column) for K8: ranks with many duplicates,
    columns near 2^28 so only the pair tells keys apart; and the token
    plane of the packed pairs."""
    kh = sr_runs(rng, C, runs, hi=4)
    kl = np.where(kh == SENTINEL, SENTINEL,
                  rng.integers(0, 9, kh.size) + (1 << 28)).astype(np.int32)
    return kh, kl, sr_tokens(rng, kh.astype(np.int64) << 32 | kl, C)


def sr_pair1_keys(rng, C, runs=64):
    """K7 keys (rank << 23) | (j << 1) | is_product: run 0 empty, run 1
    full, odd runs with columns in [0, 30) (long runs of one key), even
    runs with columns up to 2^22; about a fifth of each run's keys also
    carry their mask twin (is_product 0)."""
    pk = np.full((runs, C), SENTINEL, np.int64)
    for r in range(1, runs):
        L = C if r == 1 else int(rng.integers(1, C))
        rank = rng.integers(0, 255, L)
        j = rng.integers(0, 30 if r % 2 else 1 << 22, L)
        pk[r, :L] = (rank << 23) | (j << 1) | 1
        tok = np.unique((rank << 23) | (j << 1))[: L // 3]
        tok = tok[rng.random(tok.size) < 0.6]
        pk[r, L - tok.size:L] = tok
        rng.shuffle(pk[r])
    return pk.reshape(-1).astype(np.int32)


def sr_err(got, want, exact):
    """Every returned key plane equal; max |value difference| at kept
    slots, asserted 0 when ``exact``, else <= FP32_TOL * max|v|.  K7's one
    count plane is compared whole and must count something."""
    if not isinstance(got, tuple):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        assert np.array_equal(g, w), "K7 != plain"
        assert (w > 0).any()
        return 0.0
    for g, w in zip(got[:-1], want[:-1]):
        assert np.array_equal(g.cpu().numpy(), w.cpu().numpy()), "keys"
    kept = got[0].cpu().numpy() != SENTINEL
    assert kept.any()
    g = got[-1].cpu().numpy()[kept].astype(np.float64)
    w = want[-1].cpu().numpy()[kept].astype(np.float64)
    err = float(np.abs(g - w).max(initial=0.0))
    bound = 0.0 if exact else FP32_TOL * float(np.abs(w).max(initial=0.0))
    assert err <= bound, f"sort-reduce err {err} > {bound}"
    return err

"""Inputs and comparisons for holding the sort-reduce kernels (K5-K8,
kernels/sortreduce.py) against their plain versions, operands for the
fast SpGEMM tier's full-row edge case, misaligned copies of the SpMV
kernels' operands, the RMAT graph generator of the benchmarks,
pending set/remove events with their host reference, and the payloads
of every width that K9 (kernels/static_route.py) moves.  Used by
chip_smoke.py and the tests, among them tests/test_torch_cuda.py;
nothing here launches a kernel."""

from __future__ import annotations

import numpy as np
import torch

from .core import monoid as TM
from .kernels import sortreduce as SRD
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


def _coords(rng, shape, k):
    return np.stack([rng.integers(0, shape[0], k),
                     rng.integers(0, shape[1], k)], 1)


def _pick(rng, stored, k):
    return stored[rng.integers(0, len(stored), k)] if len(stored) \
        else np.zeros((0, 2), np.int64)


def pending_events(rng, shape, n_set, n_remove, stored):
    """A list of ("set", i, j, value) and ("remove", i, j, None) events:
    ``n_set`` sets, half on the ``stored`` coordinates (an (k, 2) array)
    and half anywhere, a fifth of them repeating an earlier set's entry;
    then ``n_remove`` removes, a third on entries set before, a third on
    stored entries, a third anywhere.  Values are integers 1..255 (exact
    in every type the tests use)."""
    pick = _pick(rng, stored, n_set // 2)
    ij = np.concatenate([pick, _coords(rng, shape, n_set - len(pick))])
    rng.shuffle(ij)
    rep = np.flatnonzero(rng.random(n_set) < 0.2)
    rep = rep[rep > 0]
    ij[rep] = ij[rng.integers(0, rep)]       # an earlier set's entry
    events = [("set", int(i), int(j), int(v))
              for (i, j), v in zip(ij, rng.integers(1, 256, n_set))]
    k = n_remove // 3
    rm = np.concatenate([ij[rng.integers(0, n_set, k)],
                         _pick(rng, stored, k),
                         _coords(rng, shape, n_remove - 2 * k)])
    rng.shuffle(rm)
    return events + [("remove", int(i), int(j), None) for i, j in rm]


def apply_events(rows, cols, vals, events, shape):
    """Host reference of wait(): ``events`` applied in order to the
    entries (rows, cols, vals), given in row-major order without repeats;
    returns the result's (rows, cols, vals) in row-major order.  The last
    event of each entry decides: a set stores its value, a remove
    deletes.  Binary searches and inserts only: no sort of the entries."""
    n = shape[1]
    last = {}
    for op, i, j, v in events:
        last[i * n + j] = v if op == "set" else None
    keys = np.asarray(rows, np.int64) * n + np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    ek = np.sort(np.fromiter(last, np.int64, len(last)))
    pos = np.searchsorted(keys, ek)
    hit = pos < keys.size
    hit[hit] = keys[pos[hit]] == ek[hit]
    keep = np.ones(keys.size, bool)
    keep[pos[hit]] = False
    setk = np.array([k for k in ek if last[k] is not None], np.int64)
    setv = np.array([last[k] for k in setk], vals.dtype)
    keys, vals = keys[keep], vals[keep]
    at = np.searchsorted(keys, setk)
    keys, vals = np.insert(keys, at, setk), np.insert(vals, at, setv)
    return keys // n, keys % n, vals


def shifted(t, by):
    """``t`` as a contiguous view ``by`` rows (elements of a 1-D tensor)
    into a fresh buffer: its 16-byte alignment moves by ``by`` rows (the
    SpMV kernels' 16-byte loads start where their operands reach it; K9
    picks its unit by it)."""
    buf = torch.empty((t.shape[0] + by,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    out = buf[by:]
    out.copy_(t)
    return out


# K9's payload kinds: every width the port stores (1, 2, 4, 8, 16 bytes)
# and struct rows
K9_PAYLOADS = {"bool": (torch.bool, ()), "int8": (torch.int8, ()),
               "int16": (torch.int16, ()), "fp32": (torch.float32, ()),
               "fp64": (torch.float64, ()), "uint64": (torch.uint64, ()),
               "fc64": (torch.complex128, ()),
               "int32x3": (torch.int32, (3,)),
               "int64x2": (torch.int64, (2,))}


def k9_payload(rng, n, kind):
    """``n`` rows of the K9 payload ``kind`` (a key of ``K9_PAYLOADS``) on
    the CPU: normal floats, random bits for the integer types."""
    dt, shape = K9_PAYLOADS[kind]
    size = (n,) + shape
    if dt == torch.bool:
        return torch.from_numpy(rng.random(size) < 0.5)
    if dt.is_complex:
        return torch.from_numpy(rng.standard_normal(size)
                                + 1j * rng.standard_normal(size))
    if dt.is_floating_point:
        return torch.from_numpy(rng.standard_normal(size)).to(dt)
    out = torch.empty(size, dtype=dt)
    raw = rng.integers(0, 256, out.numel() * out.element_size(),
                       dtype=np.uint8)
    out.reshape(-1).view(torch.uint8).copy_(torch.from_numpy(raw))
    return out


def same_bits(a, b) -> bool:
    """Same shape, dtype and bytes (NaN-safe, any dtype)."""
    def raw(t):
        return t.reshape(-1).clone(memory_format=torch.contiguous_format) \
            .view(torch.uint8).cpu()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        raw(a), raw(b))


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
    """int32 keys of C-slot runs (C = 32768 by default; any C in 128 ...
    32768) at the edges of the kernels' layouts (8 slots a thread, 256 a
    warp, a block of 2048 slots at C <= 2048 and of 8192 at C = 8192,
    C = 32768 on a cluster of 4 blocks of 8192), each run shuffled unless
    said otherwise:
      0. group boundaries exactly at multiples of 8 (a thread's slots),
         256 (a warp's) and C / 4 in the sorted run;
      1. one group over sorted slots [0.27 C, 0.76 C) (at 32768 it spans
         three of the four blocks);
      2. one group over the second half of the sorted run, to its end;
      3. all keys distinct: a permutation of [9, C + 9), whose smallest
         key is run 2's last group's (runs are separate even where a
         block holds both);
      4. descending keys (groups of 3), not shuffled;
      5. keys 2^31 - 2 (100 of them, fewer below C = 2048) beside
         SENTINEL pads and large keys;
      6. SENTINEL everywhere but the last slot (not shuffled);
    then, for C < 8192, random partly filled runs up to 8192 / C + 3 runs
    in all.  At C = 128 and 512, where a block holds 16 and 4 runs side by
    side, the last block is then only partly filled; at C = 2048 one run
    fills a block, so neither case arises there."""
    q = C // 4
    s = np.arange(C, dtype=np.int64)
    bounds = np.where(s < q // 4, s // 8,
                      np.where(s < 2 * q, 4096 + s // 256, 65536 + s // q))
    lo, hi = C * 9000 // 32768, C * 25000 // 32768
    span = np.concatenate([rng.integers(0, 9, lo), np.full(hi - lo, 9),
                           rng.integers(10, 100, C - hi)])
    tail = np.concatenate([rng.integers(0, 9, C // 2), np.full(C // 2, 9)])
    big = np.full(C, SENTINEL, np.int64)
    n_top, n_big = min(100, C // 16), C * 20000 // 32768
    big[:n_top] = SENTINEL - 1
    big[n_top:n_big] = rng.integers(1 << 30, SENTINEL - 1, n_big - n_top)
    last = np.full(C, SENTINEL, np.int64)
    last[-1] = 12345
    runs = [bounds, span, tail, rng.permutation(C) + 9, (C - 1 - s) // 3,
            big, last]
    for r in (0, 1, 2, 5):
        rng.shuffle(runs[r])
    keys = np.concatenate(runs)
    extra = 8192 // C + 3 - len(runs)
    if extra > 0:
        keys = np.concatenate([keys, sr_runs(rng, C, extra + 1)[C:]])
    return keys.astype(np.int32)


def sr_wide_edge_keys(rng, C=32768):
    """K8's two key planes from ``sr_edge_runs``: key k becomes (k >> 4,
    (k & 15) - 8), the same order and groups, with negative second keys
    and first keys past 2^23; SENTINEL stays SENTINEL in both."""
    k = sr_edge_runs(rng, C).astype(np.int64)
    sent = k == SENTINEL
    kh = np.where(sent, SENTINEL, k >> 4).astype(np.int32)
    kl = np.where(sent, SENTINEL, (k & 15) - 8).astype(np.int32)
    return kh, kl


def sr_pair1_edge_runs(rng, C=32768):
    """K7 keys (rank 0: (j << 1) | is_product) of C-slot runs whose
    sorted groups start exactly at the layouts' edges (multiples of 8,
    256 and 8192 below C, and C / 2):
      0. at each edge b, a mask token at sorted slot b - 1 and the
         products of its twin from b on (at 32768 the group from 8192
         runs into the third block);
      1. the same without the tokens: the slot before b holds another
         group's product (key - 2);
      2. at each edge, a token at b - 1 whose products never come, and
         products from b on whose token sits elsewhere;
    the other slots random groups of 1-5 products, about a third of them
    with their token; one SENTINEL pad; each run shuffled."""
    edges = sorted({e for e in (8, 256, 8192, 16384, 24576, C // 2)
                    if e < C})
    runs = []
    for kind in range(3):
        out, g, pos = [], 1, 0
        for b in edges + [C]:
            if pos > b - 1:
                continue                  # inside the group before
            while pos < b - 1:
                L = int(min(rng.integers(1, 6), b - 1 - pos))
                tok = rng.random() < 0.3 and L > 1
                out += [g << 1] * tok + [(g << 1) | 1] * (L - tok)
                pos += L
                g += 1
            if b == C:
                break
            if kind == 0:
                out.append(g << 1)                       # the twin
            elif kind == 1:
                out.append(((g - 1) << 1) | 1)           # key - 2
            else:
                out.append((g + 1) << 1)                 # another's token
            n = 8 if b == edges[0] else int(rng.integers(1, 40))
            if b == 8192 and C == 32768:
                n = 8192 + 300
            if kind == 2:
                out += [((g + 2) << 1) | 1] * n
                g += 3
            else:
                out += [(g << 1) | 1] * n
                g += 1
            pos = b + n
        k = np.asarray(out[:C - 1] + [SENTINEL] * (C - min(len(out), C - 1)),
                       np.int64)
        rng.shuffle(k)
        runs.append(k)
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


def sr_cases(rng, C, edge, on):
    """The K5-K8 calls that hold the kernels against their plain versions
    at C: on random runs (``edge`` False; 64 runs, or 8192 / C + 5 at C <
    8192, which leaves the last 2048-slot block partly filled at C = 128
    and 512) or on the layouts' edge runs,
    each plane made by ``on`` (a numpy array -> the tensor to pass).
    Yields (kernel, wrapper, plain version, args, kwargs, exact)."""
    runs = 64 if C >= 8192 else 8192 // C + 5
    keys = sr_edge_runs(rng, C) if edge else sr_runs(rng, C, runs)
    vals = {k: on(sr_values(rng, keys.size, k))
            for k in ("f32", "i32", "bool")}
    toks = on(sr_tokens(rng, keys, C))
    for kind, mon in (("i32", "PLUS"), ("f32", "PLUS"), ("f32", "MIN"),
                      ("f32", "MAX"), ("bool", "LOR")):
        args = (on(keys), vals[kind], C, getattr(TM, mon))
        exact = not (kind == "f32" and mon == "PLUS")
        kw = {"logical": kind == "bool"}
        yield ("K5", SRD.sort_reduce_rows, SRD.sort_reduce_rows_plain, args,
               kw, exact)
        for want in (True, False):
            yield ("K6", SRD.sort_reduce_rows_tok,
                   SRD.sort_reduce_rows_tok_plain,
                   args[:2] + (toks,) + args[2:], dict(kw, want_token=want),
                   exact)
    kh, kl = sr_wide_edge_keys(rng, C) if edge else \
        sr_wide_keys(rng, C, runs)[:2]
    tw = on(sr_tokens(rng, kh.astype(np.int64) << 32
                      | (kl.astype(np.int64) & 0xffffffff), C))
    for mon, kind in (("PLUS", "f32"), ("MIN", "f32"), ("PLUS", "i32")):
        for tk, want in ((None, True), (tw, True), (tw, False)):
            yield ("K8", SRD.sort_reduce_rows_wide,
                   SRD.sort_reduce_rows_wide_plain,
                   (on(kh), on(kl), vals[kind], C, getattr(TM, mon)),
                   dict(toks=tk, want_token=want),
                   not (kind == "f32" and mon == "PLUS"))
    pk = on(sr_pair1_edge_runs(rng, C) if edge else
            sr_pair1_keys(rng, C, runs))
    for want in (True, False):
        yield ("K7", SRD.sort_reduce_pair1, SRD.sort_reduce_pair1_plain,
               (pk, C), dict(want_token=want), True)


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

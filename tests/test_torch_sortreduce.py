"""Port parity: the plain versions of the sort-reduce kernels K5-K8
(graphblas_tpu_torch.kernels.sortreduce) against the JAX package's
Pallas kernels run in interpret mode, at C in {128, 512, 2048}, and K5/K6
at C = 32768 (the fast tier's top class) against a numpy sort-and-group.

Inputs (numpy, from a seed): runs with many duplicate keys, empty
(all-SENTINEL) runs, full runs and partly filled runs.  Only kept slots
are compared: keys exactly, values exactly for int32, bool and min/max
(and K7's counts), within 1e-5*max|v| for fp32 plus (summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.core import monoid as JM
from graphblas_tpu.kernels import sortreduce as JSRD
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.kernels import sortreduce as SRD
from torch_parity import cpu_default  # noqa: F401

SENT = SRD.SENTINEL
FP32_TOL = 1e-5


def _keys(rng, C, runs=4, hi=40):
    """runs x C keys: run 0 empty, run 1 full, the rest partly filled."""
    k = np.full((runs, C), SENT, np.int64)
    for r in range(1, runs):
        L = C if r == 1 else int(rng.integers(1, C))
        k[r, :L] = rng.integers(0, hi, L)
        rng.shuffle(k[r])
    return k.reshape(-1).astype(np.int32)


def _vals(rng, n, kind):
    if kind == "f32":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "bool":
        return (rng.random(n) < 0.5).astype(np.int32)
    return rng.integers(-50, 50, n).astype(np.int32)


def _tokens(rng, keys, C):
    """1 = mask entry (at most one per key and run), 2 = product, 0 pad."""
    t = np.where(keys == SENT, 0, 2).astype(np.int32)
    for r in range(keys.size // C):
        run = keys[r * C:(r + 1) * C]
        u, first = np.unique(run, return_index=True)
        pick = (u != SENT) & (rng.random(u.size) < 0.5)
        t[r * C + first[pick]] = 1
    return t


def _jx(a):
    return jnp.asarray(a.reshape(-1, 128))


def _check(ok_j, ov_j, ok_t, ov_t, kind, mon, ok2_j=None, ok2_t=None):
    ok_j = np.asarray(ok_j).reshape(-1)
    ov_j = np.asarray(ov_j).reshape(-1)
    ok_t, ov_t = ok_t.numpy(), ov_t.numpy()
    np.testing.assert_array_equal(ok_t, ok_j)
    if ok2_j is not None:
        np.testing.assert_array_equal(ok2_t.numpy(),
                                      np.asarray(ok2_j).reshape(-1))
    kept = ok_j != SENT
    assert kept.any()
    a, b = ov_j[kept], ov_t[kept]
    if kind == "f32" and mon == "PLUS":
        bound = FP32_TOL * float(np.abs(a).max())
        assert float(np.abs(a.astype(np.float64) - b).max()) <= bound
    else:
        np.testing.assert_array_equal(b, a)


K5_CASES = [(128, "i32", "PLUS"), (512, "f32", "PLUS"), (2048, "f32", "MIN"),
            (512, "bool", "LOR"), (128, "f32", "MAX")]


@pytest.mark.parametrize("C,kind,mon", K5_CASES)
def test_sort_reduce_rows_matches(C, kind, mon):
    rng = np.random.default_rng(C + len(kind) + len(mon))
    keys = _keys(rng, C)
    vals = _vals(rng, keys.size, kind)
    logical = kind == "bool"
    ok_j, ov_j = JSRD.sort_reduce_rows(_jx(keys), _jx(vals), C,
                                       getattr(JM, mon), logical=logical,
                                       interpret=True)
    ok_t, ov_t = SRD.sort_reduce_rows(torch.from_numpy(keys),
                                      torch.from_numpy(vals), C,
                                      getattr(TM, mon), logical=logical)
    _check(ok_j, ov_j, ok_t, ov_t, kind, mon)


@pytest.mark.parametrize("C,kind,want", [(512, "f32", True),
                                         (2048, "i32", False)])
def test_sort_reduce_rows_tok_matches(C, kind, want):
    rng = np.random.default_rng(7 + C)
    keys = _keys(rng, C)
    vals = _vals(rng, keys.size, kind)
    toks = _tokens(rng, keys, C)
    ok_j, ov_j = JSRD.sort_reduce_rows_tok(_jx(keys), _jx(vals), _jx(toks),
                                           C, JM.PLUS, want_token=want,
                                           interpret=True)
    ok_t, ov_t = SRD.sort_reduce_rows_tok(
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(toks), C, TM.PLUS, want_token=want)
    _check(ok_j, ov_j, ok_t, ov_t, kind, "PLUS")


@pytest.mark.parametrize("C,want", [(2048, True), (128, False)])
def test_sort_reduce_pair1_matches(C, want):
    """Keys pack (rank << 23) | (j << 1) | is_product; mask tokens are
    unique per (rank, j); exact counts."""
    rng = np.random.default_rng(11 + C)
    runs = 4
    keys = np.full((runs, C), SENT, np.int64)
    for r in range(1, runs):
        L = C if r == 1 else int(rng.integers(1, C))
        rank = rng.integers(0, 6, L)
        j = rng.integers(0, 30, L)
        keys[r, :L] = (rank << 23) | (j << 1) | 1
        tok = np.unique((rank << 23) | (j << 1))[: L // 3]
        tok = tok[rng.random(tok.size) < 0.6]
        keys[r, L - tok.size:L] = tok            # replaces some products
        rng.shuffle(keys[r])
    keys = keys.reshape(-1).astype(np.int32)
    ov_j = np.asarray(JSRD.sort_reduce_pair1(
        _jx(keys), C, want_token=want, interpret=True)).reshape(-1)
    ov_t = SRD.sort_reduce_pair1(torch.from_numpy(keys), C,
                                 want_token=want).numpy()
    assert (ov_j > 0).any()
    np.testing.assert_array_equal(ov_t, ov_j)


@pytest.mark.parametrize("C,kind,mon,tok,want", [
    (512, "f32", "PLUS", False, True),
    (2048, "i32", "PLUS", True, True),
    (128, "bool", "LOR", True, False)])
def test_sort_reduce_rows_wide_matches(C, kind, mon, tok, want):
    """Lexicographic (rank, column) planes; columns past 2^23."""
    rng = np.random.default_rng(13 + C)
    keysh = _keys(rng, C, hi=5)
    keysl = np.where(keysh == SENT, SENT,
                     rng.integers(0, 12, keysh.size) + (1 << 24)
                     ).astype(np.int32)
    vals = _vals(rng, keysh.size, kind)
    logical = kind == "bool"
    toks = None
    if tok:
        toks = _tokens(rng, keysh.astype(np.int64) << 32 | keysl, C)
    okh_j, okl_j, ov_j = JSRD.sort_reduce_rows_wide(
        _jx(keysh), _jx(keysl), _jx(vals), C, getattr(JM, mon),
        toks=None if toks is None else _jx(toks), want_token=want,
        logical=logical, interpret=True)
    okh_t, okl_t, ov_t = SRD.sort_reduce_rows_wide(
        torch.from_numpy(keysh), torch.from_numpy(keysl),
        torch.from_numpy(vals), C, getattr(TM, mon),
        toks=None if toks is None else torch.from_numpy(toks),
        want_token=want, logical=logical)
    _check(okh_j, ov_j, okh_t, ov_t, kind, mon, okl_j, okl_t)


def _numpy_sort_reduce(keys, vals, C, ufunc, toks=None, want=True):
    """Per run: the sorted unique keys that are kept and their totals
    (fp32 plus summed in fp64)."""
    out = []
    for r in range(keys.size // C):
        k, v = keys[r * C:(r + 1) * C], vals[r * C:(r + 1) * C]
        u, inv = np.unique(k, return_inverse=True)
        acc = np.full(u.size, np.nan)
        for g in range(u.size):           # few groups: hi = 40
            acc[g] = ufunc.reduce(v[inv == g].astype(np.float64))
        keep = u != SENT
        if toks is not None:
            t = toks[r * C:(r + 1) * C]
            has_tok = np.array([(t[inv == g] == 1).any()
                                for g in range(u.size)])
            has_prod = np.array([(t[inv == g] == 2).any()
                                 for g in range(u.size)])
            keep &= has_prod & (has_tok == want)
        out.append((u[keep], acc[keep]))
    return out


@pytest.mark.parametrize("kind,mon,tok", [("f32", "PLUS", False),
                                          ("i32", "MIN", True),
                                          ("bool", "LOR", True)])
def test_sort_reduce_plain_at_32768(kind, mon, tok):
    """K5 / K6 plain versions at C = 32768: run 1 full, run 2 one key over
    the whole run, the rest partly filled."""
    from graphblas_tpu_torch import testing as GT
    C = 32768
    rng = np.random.default_rng(len(kind) + 3 * tok)
    keys = GT.sr_runs(rng, C, runs=4)
    vals = GT.sr_values(rng, keys.size, kind)
    toks = GT.sr_tokens(rng, keys, C) if tok else None
    logical = kind == "bool"
    args = (torch.from_numpy(keys), torch.from_numpy(vals))
    if tok:
        ok, ov = SRD.sort_reduce_rows_tok(*args, torch.from_numpy(toks), C,
                                          getattr(TM, mon), want_token=True,
                                          logical=logical)
    else:
        ok, ov = SRD.sort_reduce_rows(*args, C, getattr(TM, mon),
                                      logical=logical)
    ufunc = {"PLUS": np.add, "MIN": np.minimum, "LOR": np.logical_or}[mon]
    want = _numpy_sort_reduce(keys, vals, C, ufunc, toks)
    ok, ov = ok.numpy(), ov.numpy()
    for r, (u, tot) in enumerate(want):
        k = ok[r * C:(r + 1) * C]
        kept = k != SENT
        np.testing.assert_array_equal(k[kept], u)
        got = ov[r * C:(r + 1) * C][kept].astype(np.float64)
        if kind == "f32":
            assert np.abs(got - tot).max(initial=0) <= \
                FP32_TOL * np.abs(tot).max(initial=0)
        else:
            np.testing.assert_array_equal(got, tot.astype(got.dtype))
    if not tok:                                     # one key, one group
        assert (ok[2 * C:3 * C] != SENT).sum() == 1


def test_wrappers_refuse_bad_capacity():
    keys = torch.full((96,), SENT, dtype=torch.int32)
    with pytest.raises(ValueError):
        SRD.sort_reduce_rows(keys, torch.zeros(96), 96, TM.PLUS)
    with pytest.raises(ValueError):
        SRD.sort_reduce_pair1(torch.full((32768,), SENT, dtype=torch.int32),
                              32768)
    big = torch.full((32768,), SENT, dtype=torch.int32)
    with pytest.raises(ValueError):         # K8 takes C <= 8192 only
        SRD.sort_reduce_rows_wide(big, big, torch.zeros(32768), 32768,
                                  TM.PLUS)

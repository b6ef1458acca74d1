"""Per-run sort + segmented monoid reduce: the counterpart of
``graphblas_tpu.kernels.sortreduce`` (K5-K8), the SpGEMM "shared hash
table" replacement of the SELL engine (ops/spgemm_sell.py).

Layout contract (as the TPU kernels', on flat 1-D tensors instead of an
(S, 128) raster): the key plane's length is a multiple of C and slot p
belongs to run p // C.  Each run is sorted ascending by key, equal keys
are combined under the add monoid, and the unique key sits at its
group's LAST slot with SENTINEL (2^31-1) at every other slot; the monoid
total sits at that slot.  Values at slots that are not kept are
unspecified.  Pad slots carry SENTINEL keys and are never kept.

  * ``sort_reduce_rows``      K5 (replaces ``sortreduce._kernel_fn``)
  * ``sort_reduce_rows_tok``  K6: a token plane (1 = mask entry, 2 =
    product, 0 = pad) rides the sort; a group survives only if it holds a
    product and its token presence equals ``want_token`` (the dot3 mask
    filter, plain or complemented)
  * ``sort_reduce_pair1``     K7: keys pack (rank << 23) | (j << 1) |
    is_product; returns per-slot counts (the product count at kept group
    ends, 0 elsewhere); a group's mask twin is the key - 1 just before it
  * ``sort_reduce_rows_wide`` K8: lexicographic (key, key2) sort; K5 or K6

Each wrapper launches the CUDA kernel of ``csrc/sortreduce.cu`` for CUDA
tensors (and counts the launch in ``launches`` and, by C, in
``launches_by_cap``) and runs its plain torch version (``*_plain``) for
CPU tensors.  Values are int32 (bool carried as 0/1 with ``logical=True``)
or float32.  Every wrapper takes every C in ``CAPS``, as the JAX wrappers
do.  The kernels sort and scan in registers (warp shuffles; shared memory
only to change layouts): at C <= 8192 a thread block holds one run or
several side by side, at C = 32768 a run takes a cluster of four blocks
that exchange through each other's shared memory.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import segment as K

SENTINEL = 2**31 - 1
# C the CUDA kernels take: the run classes of the JAX package (all below
# 2^20, where K7 keeps its twin bit)
CAPS = (128, 512, 2048, 8192, 32768)

# launches of the CUDA kernels (CPU calls run the plain versions,
# uncounted), in total and by (wrapper name, C)
launches = {"sort_reduce_rows": 0, "sort_reduce_rows_tok": 0,
            "sort_reduce_pair1": 0, "sort_reduce_rows_wide": 0}
launches_by_cap: dict = {}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0
    launches_by_cap.clear()


def _count(name: str, C: int) -> None:
    launches[name] += 1
    launches_by_cap[(name, C)] = launches_by_cap.get((name, C), 0) + 1

# monoid name -> kernel op, for value planes and for bool carried in int32
_OPS = {"GrB_PLUS": "plus", "GrB_TIMES": "times", "GrB_MIN": "min",
        "GrB_MAX": "max"}
_LOGICAL_OPS = {"GrB_LOR": "lor", "GrB_PLUS": "lor", "GrB_MAX": "lor",
                "GrB_LAND": "land", "GrB_TIMES": "land", "GrB_MIN": "land",
                "GrB_LXOR": "lxor", "GrB_LXNOR": "eq", "GrB_EQ": "eq"}


def kernel_op(monoid, logical: bool):
    """The CUDA kernel's op for ``monoid``, or None when it has none."""
    return (_LOGICAL_OPS if logical else _OPS).get(monoid.op.name)


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _sort_runs(keys, C: int, keys2=None):
    """Per-run stable ascending sort order (lexicographic with keys2) as
    flat indices, and the sorted key plane(s)."""
    R = keys.numel() // C
    k = keys.reshape(R, C)
    if keys2 is None:
        order = torch.sort(k, dim=1, stable=True).indices
    else:
        o2 = torch.sort(keys2.reshape(R, C), dim=1, stable=True).indices
        o1 = torch.sort(torch.gather(k, 1, o2), dim=1, stable=True).indices
        order = torch.gather(o2, 1, o1)
    base = torch.arange(R, device=keys.device)[:, None] * C
    flat = (order + base).reshape(-1)
    return flat, keys[flat], None if keys2 is None else keys2[flat]


def _groups(sk, C: int, sk2=None):
    """(group start flags, group end flags) of sorted runs."""
    n = sk.numel()
    pos = torch.arange(n, device=sk.device) % C
    diff = torch.ones(n + 1, dtype=torch.bool, device=sk.device)
    d = sk[1:] != sk[:-1]
    if sk2 is not None:
        d = d | (sk2[1:] != sk2[:-1])
    diff[1:-1] = d
    start = diff[:-1] | (pos == 0)
    end = diff[1:] | (pos == C - 1)
    return start, end


def _reduce_groups(sv, start, monoid, logical: bool):
    """Every slot gets its group's monoid total (fp32 plus summed in
    fp64, as the SpMV plain versions do)."""
    gid = torch.cumsum(start.to(torch.int64), 0) - 1
    ng = int(gid[-1]) + 1 if gid.numel() else 0
    if logical:
        tot = K.segment_reduce(sv != 0, gid, ng, monoid).to(sv.dtype)
    elif sv.dtype == torch.float32 and monoid.op.name == "GrB_PLUS":
        tot = K.segment_reduce(sv.double(), gid, ng, monoid).float()
    else:
        tot = K.segment_reduce(sv, gid, ng, monoid)
    return tot[gid], gid, ng


def _token_keep(st, gid, ng, want_token: bool):
    """Per-slot: the group holds a product and its token presence equals
    ``want_token``."""
    has = []
    for bit in (1, 2):
        b = ((st & bit) != 0).to(torch.int32)
        has.append(torch.zeros(ng, dtype=torch.int32, device=st.device)
                   .scatter_reduce_(0, gid, b, "amax")[gid] != 0)
    return has[1] & (has[0] == bool(want_token))


def _sort_reduce_plain(keys, vals, C, monoid, logical, keys2=None,
                       toks=None, want_token=True):
    flat, sk, sk2 = _sort_runs(keys, C, keys2)
    start, end = _groups(sk, C, sk2)
    ov, gid, ng = _reduce_groups(vals[flat], start, monoid, logical)
    keep = end & (sk != SENTINEL)
    if toks is not None:
        keep &= _token_keep(toks[flat], gid, ng, want_token)
    sent = torch.full_like(sk, SENTINEL)
    ok = torch.where(keep, sk, sent)
    ok2 = None if sk2 is None else torch.where(keep, sk2, sent)
    return ok, ok2, ov


def sort_reduce_rows_plain(keys, vals, C, monoid, *, logical=False):
    ok, _, ov = _sort_reduce_plain(keys, vals, C, monoid, logical)
    return ok, ov


def sort_reduce_rows_tok_plain(keys, vals, toks, C, monoid, *,
                               want_token=True, logical=False):
    ok, _, ov = _sort_reduce_plain(keys, vals, C, monoid, logical,
                                   toks=toks, want_token=want_token)
    return ok, ov


def sort_reduce_rows_wide_plain(keysh, keysl, vals, C, monoid, *, toks=None,
                                want_token=True, logical=False):
    return _sort_reduce_plain(keysh, vals, C, monoid, logical, keys2=keysl,
                              toks=toks, want_token=want_token)


def sort_reduce_pair1_plain(keys, C, *, want_token=True):
    flat, sk, _ = _sort_runs(keys, C)
    start, end = _groups(sk, C)
    pos = torch.arange(sk.numel(), device=sk.device) % C
    prev = torch.cat([sk[:1], sk[:-1]])
    twin = start & (pos != 0) & (prev == sk - 1)
    is_prod = ((sk & 1) != 0) & (sk != SENTINEL)
    gid = torch.cumsum(start.to(torch.int64), 0) - 1
    ng = int(gid[-1]) + 1 if gid.numel() else 0
    cnt = torch.zeros(ng, dtype=torch.int32, device=sk.device).index_add_(
        0, gid, is_prod.to(torch.int32))[gid]
    has_twin = torch.zeros(ng, dtype=torch.int32, device=sk.device) \
        .index_add_(0, gid, twin.to(torch.int32))[gid] != 0
    keep = end & is_prod & (cnt > 0) & (has_twin == bool(want_token))
    return torch.where(keep, cnt, torch.zeros_like(cnt))


# ---------------------------------------------------------------------------
# wrappers: CUDA kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def _cap(C) -> int:
    C = int(C)
    if C not in CAPS:
        raise ValueError(f"sort-reduce: C={C} not in {CAPS}")
    return C


def _check(C, keys, others, vals=None, logical=False, monoid=None):
    dev = keys.device
    n = keys.numel()
    if n % C:
        raise ValueError(f"sort-reduce: {n} slots is not a multiple of C")
    _cuda.require(keys, "keys", torch.int32, dev)
    for name, t in others:
        if t is not None:
            _cuda.require(t, name, torch.int32, dev, n)
    op = None
    if vals is not None:
        if vals.dtype not in _cuda.SR_VDTYPE or (logical and
                                                 vals.dtype != torch.int32):
            raise TypeError(f"sort-reduce: values of {vals.dtype}")
        _cuda.require(vals, "vals", vals.dtype, dev, n)
        op = kernel_op(monoid, logical)
        if op is None or (vals.dtype == torch.float32 and op not in
                          ("plus", "times", "min", "max")):
            raise ValueError(f"sort-reduce: no kernel for {monoid.name} "
                             f"on {vals.dtype}")
    return op


def _outputs(keys, vals, wide=False):
    ok = torch.empty_like(keys)
    return ok, (torch.empty_like(keys) if wide else None), \
        torch.empty_like(vals)


def sort_reduce_rows(keys, vals, C, monoid, *, logical=False):
    """K5: (okeys, ovals) of C-slot runs (see the module docstring)."""
    C = _cap(C)
    if not keys.is_cuda:
        return sort_reduce_rows_plain(keys, vals, C, monoid, logical=logical)
    op = _check(C, keys, [], vals, logical, monoid)
    ok, _, ov = _outputs(keys, vals)
    _cuda.sort_reduce(keys, None, vals, None, ok, None, ov, C, op, True)
    _count("sort_reduce_rows", C)
    return ok, ov


def sort_reduce_rows_tok(keys, vals, toks, C, monoid, *, want_token=True,
                         logical=False):
    """K6: K5 with the token plane ``toks`` (1 mask entry, 2 product)."""
    C = _cap(C)
    if not keys.is_cuda:
        return sort_reduce_rows_tok_plain(keys, vals, toks, C, monoid,
                                          want_token=want_token,
                                          logical=logical)
    op = _check(C, keys, [("toks", toks)], vals, logical, monoid)
    ok, _, ov = _outputs(keys, vals)
    _cuda.sort_reduce(keys, None, vals, toks, ok, None, ov, C, op,
                      want_token)
    _count("sort_reduce_rows_tok", C)
    return ok, ov


def sort_reduce_rows_wide(keysh, keysl, vals, C, monoid, *, toks=None,
                          want_token=True, logical=False):
    """K8: lexicographic (keysh, keysl) sort-reduce, with or without the
    token plane; returns (okeysh, okeysl, ovals)."""
    C = _cap(C)
    if not keysh.is_cuda:
        return sort_reduce_rows_wide_plain(keysh, keysl, vals, C, monoid,
                                           toks=toks, want_token=want_token,
                                           logical=logical)
    op = _check(C, keysh, [("keysl", keysl), ("toks", toks)], vals,
                logical, monoid)
    okh, okl, ov = _outputs(keysh, vals, wide=True)
    _cuda.sort_reduce(keysh, keysl, vals, toks, okh, okl, ov, C, op,
                      want_token)
    _count("sort_reduce_rows_wide", C)
    return okh, okl, ov


def sort_reduce_pair1(keys, C, *, want_token=True):
    """K7: per-slot product counts of kept groups (0 elsewhere)."""
    C = _cap(C)
    if not keys.is_cuda:
        return sort_reduce_pair1_plain(keys, C, want_token=want_token)
    _check(C, keys, [])
    out = torch.empty_like(keys)
    _cuda.sort_pair1(keys, out, C, want_token)
    _count("sort_reduce_pair1", C)
    return out


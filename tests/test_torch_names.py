"""Port parity: the named algebra registry (graphblas_tpu_torch.core.names
against graphblas_tpu.core.names): the name sets, every monoid's typed
identity and terminal, attribute access, and a sample of the 1553 named
semirings run through mxm (each JAX compile costs about a second, so not
all of them)."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import names as JN
from graphblas_tpu_torch.core import names as TN
from torch_parity import assert_same, cpu_default, to_port, xla_path  # noqa

LISTS = ["semiring_names", "grb_semiring_names", "monoid_names",
         "grb_monoid_names", "binary_op_names", "unary_op_names",
         "index_unary_op_names", "type_names"]


@pytest.mark.parametrize("fn", LISTS)
def test_name_sets_match(fn):
    got, want = getattr(TN, fn)(), getattr(JN, fn)()
    assert set(got) == set(want) and len(got) == len(want)


def test_name_counts():
    """1553 semirings (1000 + 300 + 55 + 54 + 64 + 80) and 77 monoids, as
    the reference predefines."""
    assert len(set(gt.names.semiring_names())) == 1553
    assert len(set(gt.names.monoid_names())) == 77
    sizes = [len(a) * len(m) * len(t) for a, m, t in TN._SEMIRING_GROUPS]
    assert sizes == [1000, 300, 55, 54, 64, 80]


def test_every_name_resolves():
    """Every semiring name resolves to a Semiring of its declared type,
    every op and monoid name to its object; unknown names raise."""
    for name in TN.semiring_names() + TN.grb_semiring_names():
        sr = gt.lookup_name(name)
        assert isinstance(sr, gt.Semiring) and sr.name == name
        assert sr.declared_type.name == JN.lookup(name).declared_type.name
        assert sr.add.op.name == JN.lookup(name).add.op.name
        assert sr.mult.name == JN.lookup(name).mult.name
    for name in (TN.binary_op_names() + TN.unary_op_names()
                 + TN.index_unary_op_names() + TN.type_names()):
        assert type(gt.lookup_name(name)).__name__ == \
            type(JN.lookup(name)).__name__
    with pytest.raises(KeyError):
        gt.lookup_name("GxB_NOPE_TIMES_FP32")


def test_monoid_identities_and_terminals():
    """Each named monoid's identity and terminal in its declared type
    equal the JAX package's, bit for bit (UINT64 MIN: 2^64 - 1)."""
    for name in TN.monoid_names() + TN.grb_monoid_names():
        tm, jm = gt.lookup_name(name), JN.lookup(name)
        dt = tm.declared_type.np_dtype
        assert tm.declared_type.name == jm.declared_type.name
        ti, ji = tm.identity_for(dt), jm.identity_for(dt)
        assert np.asarray(ti).dtype == np.asarray(ji).dtype == dt
        assert np.asarray(ti).tobytes() == np.asarray(ji).tobytes(), name
        tt, jt = tm.terminal_for(dt), jm.terminal_for(dt)
        assert (tt is None) == (jt is None), name
        if tt is not None:
            assert np.asarray(tt).tobytes() == np.asarray(jt).tobytes()
    assert gt.lookup_name("GxB_MIN_UINT64_MONOID").identity_for(
        np.uint64) == np.uint64(2 ** 64 - 1)


def test_attribute_access():
    assert gt.names.GxB_MIN_PLUS_FP32 is gt.lookup_name("GxB_MIN_PLUS_FP32")
    assert gt.names.GrB_PLUS_MONOID_INT32.declared_type is gt.types.INT32
    assert gt.names.GxB_BOR_BAND_UINT64.declared_type is gt.types.UINT64
    assert gt.names.GrB_UINT16 is gt.types.UINT16
    with pytest.raises(AttributeError):
        gt.names.GxB_NOT_A_NAME


# a sample of each group of the 1553 (GraphBLAS.h:8258-8317), the
# unsigned and complex types among them
SAMPLE = [
    # 1000: (min|max|plus|times|any) x 20 mults x 10 real types
    "GxB_PLUS_TIMES_UINT64", "GxB_MIN_PLUS_UINT32", "GxB_MAX_MINUS_UINT16",
    "GxB_TIMES_DIV_UINT8", "GxB_PLUS_RDIV_INT16", "GxB_MAX_ISGT_INT32",
    "GxB_MIN_MAX_UINT64",
    # 300: (lor|land|lxor|eq|any) x comparators x 10 real types
    "GxB_LOR_GT_UINT64", "GxB_LAND_LE_FP32", "GxB_LXOR_NE_INT8",
    "GxB_ANY_GE_INT16", "GxB_LOR_LT_FP64",
    # 55: boolean
    "GxB_LOR_LAND_BOOL", "GxB_LXOR_FIRST_BOOL", "GxB_LAND_GE_BOOL",
    "GxB_LAND_PAIR_BOOL",
    # 54: complex
    "GxB_PLUS_TIMES_FC32", "GxB_PLUS_MINUS_FC64", "GxB_TIMES_PLUS_FC64",
    "GxB_PLUS_FIRST_FC32",
    # 64: bitwise on the unsigned types (the rest of them in SAMPLE_SCAN)
    "GxB_BXNOR_BAND_UINT64",
    # 80: positional
    "GxB_MIN_FIRSTJ_INT64", "GxB_PLUS_SECONDI1_INT32",
    "GxB_MAX_FIRSTI_INT64",
]


def _operand_scipy(rng, shape, ty):
    """A random sparse operand of the named type, as scipy CSR: integers
    over a few small values (products and sums then mix wrap-free and
    wrapping cases), complex with small integer parts, bool half true;
    the pattern is one per shape, so the JAX package compiles its
    shape-specialised pieces once."""
    m, n = shape
    k = int(m * n * 0.3)
    flat = np.random.default_rng(m).choice(m * n, k, replace=False)
    dt = ty.np_dtype
    if dt == np.bool_:
        v = rng.random(k) < 0.5
    elif dt.kind == "c":
        v = (rng.integers(-3, 4, k) + 1j * rng.integers(-3, 4, k)
             ).astype(dt)
    elif dt.kind == "u":
        top = np.iinfo(dt).max
        v = rng.integers(0, 6, k).astype(dt)
        v[::4] = top - rng.integers(0, 3, v[::4].size).astype(dt)
    else:
        v = rng.integers(-4, 6, k).astype(dt)
    return sps.csr_matrix((v, (flat // n, flat % n)), shape=shape)


def _operand(rng, shape, ty):
    """The JAX package's Matrix of ``_operand_scipy``."""
    return gb.Matrix.from_scipy(_operand_scipy(rng, shape, ty),
                                dtype=ty.np_dtype)


# semirings whose monoid the JAX package reduces by its generic scan (5-9
# s of compiling each): held against a dense numpy reference instead (one
# of the group, GxB_BXNOR_BAND_UINT64, runs against the JAX package in
# SAMPLE)
SAMPLE_SCAN = {
    "GxB_BOR_BAND_UINT64": (np.bitwise_and, np.bitwise_or),
    "GxB_EQ_EQ_UINT16": (np.equal, np.equal),
    "GxB_BXNOR_BXOR_UINT8": (np.bitwise_xor,
                             lambda x, y: ~np.bitwise_xor(x, y)),
    "GxB_BAND_BXNOR_UINT16": (lambda x, y: ~np.bitwise_xor(x, y),
                              np.bitwise_and),
    "GxB_BXOR_BOR_UINT32": (np.bitwise_or, np.bitwise_xor),
}


def _dense_pair(S):
    """(values, present) of a scipy CSR operand, explicit zeros present."""
    v = S.toarray()
    p = np.zeros(S.shape, bool)
    p[np.repeat(np.arange(S.shape[0]), np.diff(S.indptr)), S.indices] = True
    return v, p


def _dense_ref(A, B, mult, add):
    """C = A (+).(x) B on scipy operands, in dense numpy: each present
    C(i, j) folds the products of its k in order."""
    (av, ap), (bv, bp) = _dense_pair(A), _dense_pair(B)
    m, n = ap.shape[0], bp.shape[1]
    cv = [[None] * n for _ in range(m)]
    for i in range(m):
        for j in range(n):
            for k in np.flatnonzero(ap[i] & bp[:, j]):
                z = mult(av[i, k], bv[k, j])
                cv[i][j] = z if cv[i][j] is None else add(cv[i][j], z)
    present = np.array([[c is not None for c in row] for row in cv])
    return cv, present


@pytest.mark.parametrize("name", list(SAMPLE_SCAN))
def test_named_semiring_mxm_scan_monoids(name):
    """The generic-monoid semirings (EQ, BAND, BXOR, BXNOR), exact against
    a dense numpy reference."""
    mult, add = SAMPLE_SCAN[name]
    tsr = gt.lookup_name(name)
    rng = np.random.default_rng(len(SAMPLE) + list(SAMPLE_SCAN).index(name))
    ty = tsr.declared_type
    A = _operand_scipy(rng, (12, 9), ty)
    B = _operand_scipy(rng, (9, 10), ty)
    cv, present = _dense_ref(A, B, mult, add)
    Ct = gt.mxm(gt.Matrix.from_scipy(A, dtype=ty.np_dtype),
                gt.Matrix.from_scipy(B, dtype=ty.np_dtype), tsr)
    vt, pt = (a.numpy() for a in Ct.to_dense_pair())
    np.testing.assert_array_equal(pt, present)
    for i, j in zip(*np.nonzero(present)):
        assert vt[i, j] == cv[i][j] and vt.dtype == np.asarray(
            cv[i][j]).dtype


@pytest.mark.parametrize("name", SAMPLE)
def test_named_semiring_mxm(xla_path, name):
    """C = A (+).(x) B under the named semiring, exact against the JAX
    package (its typed multiply casts the operands to the declared type;
    the output is that type, or bool for comparators)."""
    jsr, tsr = JN.lookup(name), gt.lookup_name(name)
    ty = jsr.declared_type
    if ty.name in ("GrB_INT32", "GrB_INT64") and jsr.mult.positional:
        ty = gb.types.FP64                     # positional: any values
    rng = np.random.default_rng(SAMPLE.index(name))
    Aj, Bj = _operand(rng, (12, 9), ty), _operand(rng, (9, 10), ty)
    Cj = gb.mxm(Aj, Bj, jsr)
    Ct = gt.mxm(to_port(Aj), to_port(Bj), tsr)
    assert Ct.dtype.name == Cj.dtype.name
    assert_same(Cj, Ct)

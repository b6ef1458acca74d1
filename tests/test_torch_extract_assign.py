"""Port parity: extract, assign and subassign (graphblas_tpu_torch.ops.
extract, ops.assign) against graphblas_tpu on the same seeded operands,
the JAX side on its XLA path.

These ops move values (and apply at most one accum op per entry), so the
results are held bitwise equal, on every storage format, both
orientations and UINT64 values on both sides of 2^63.  Extract with a
repeated index runs the port's sparse repeat path (the JAX package
builds a dense pair there): it is held against numpy's A[np.ix_(I, J)].
So is extract from a SPARSE or HYPER matrix stored by column: the JAX
package maps its vector ids (columns) through the row map there
(``graphblas_tpu/ops/extract.py:114-115``), a reference fault.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from torch_parity import (assert_dense, assert_same,  # noqa: F401
                          cpu_default, dense_port, mask_pair, to_port,
                          typed_pair, xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

SHAPE = (24, 20)
FORMATS = ["sparse", "hyper", "bitmap", "full"]
I4 = [1, 3, 5, 9, 17, 23]
J4 = [0, 2, 4, 6, 11, 19]


def _ops(name):
    return getattr(gb.operators, name), getattr(gt.operators, name)


# ---- extract ----------------------------------------------------------------

@pytest.mark.parametrize("orient", ["row", "col"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_extract_formats(rng, fmt, orient):
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, fmt, orient, which=1)
    got = gt.extract(At, I4, J4)
    if orient == "col" and fmt in ("sparse", "hyper"):
        v, p = (np.asarray(x) for x in Aj.to_dense_pair())
        assert_dense(got, v[np.ix_(I4, J4)], p[np.ix_(I4, J4)])
    else:
        assert_same(gb.extract(Aj, I4, J4), got)


@pytest.mark.parametrize("case", ["sentinel", "compact", "unsorted",
                                  "slice", "all", "tensor"])
def test_extract_paths(rng, case):
    """The sentinel-sort branch (a quarter or more of the entries
    survive), the compact-then-sort branch, unsorted index lists, a slice,
    GrB_ALL and index tensors."""
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.int32, which=2)
    I, J = {"sentinel": (None, list(range(1, 20))),
            "compact": ([2, 7], [1, 5, 8]),
            "unsorted": (np.array([20, 3, 11, 0, 7])[::-1], [9, 1, 18, 4]),
            "slice": (slice(2, 20, 3), slice(None, None, -2)),
            "all": (None, None),
            "tensor": ([4, 8, 15], [2, 3, 19])}[case]
    It, Jt = I, J
    if case == "tensor":
        It, Jt = torch.tensor(I), torch.tensor(J)
    assert_same(gb.extract(Aj, I, J), gt.extract(At, It, Jt))


@pytest.mark.parametrize("orient", ["row", "col"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_extract_repeats(rng, orient, order):
    """Repeated indices (the sparse repeat path) against numpy."""
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, orient=orient,
                        which=3)
    I = [2, 2, 3, 9, 9, 9, 17]
    J = [0, 1, 1, 6, 6, 19]
    if order == "unsorted":
        I, J = I[::-1] + [2], [6, 0, 19, 1, 6, 1]
    v, p = (np.asarray(x) for x in Aj.to_dense_pair())
    C = gt.extract(At, I, J)
    assert C.fmt in ("sparse", "hyper")
    C.check()
    assert_dense(C, v[np.ix_(I, J)], p[np.ix_(I, J)])


def test_extract_repeats_bitmap(rng):
    """Repeated indices of a BITMAP A: the dense gather, as in JAX."""
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, "bitmap", which=3)
    I, J = [2, 2, 3], [1, 1, 1]
    assert_same(gb.extract(Aj, I, J), gt.extract(At, I, J))


def test_extract_masked_accum(rng):
    Aj, At = typed_pair(rng, SHAPE, 0.35, np.float64, which=4)
    Cj, Ct = typed_pair(rng, (6, 6), 0.4, np.float64, which=5)
    Mj, Mt = mask_pair(rng, (6, 6), 6)
    jp, tp = _ops("PLUS")
    got = gt.extract(At, I4, J4, C=Ct.dup(), mask=Mt, accum=tp)
    want = gb.extract(Aj, I4, J4, C=Cj.dup(), mask=Mj, accum=jp)
    assert_same(want, got)


@pytest.mark.parametrize("desc", ["replace", "complement", "transpose"])
def test_extract_descriptors(rng, desc):
    """replace, a complemented mask, and transpose0 (held against the JAX
    package's extract of A' stored by row, away from its fault)."""
    Aj, At = typed_pair(rng, SHAPE, 0.35, np.float64, which=7)
    Cj, Ct = typed_pair(rng, (6, 6), 0.4, np.float64, which=5)
    Mj, Mt = mask_pair(rng, (6, 6), 6)
    kw = {"replace": dict(replace=True),
          "complement": dict(mask_complement=True),
          "transpose": dict(transpose0=True)}[desc]
    if desc == "transpose":
        At = gt.transpose(At).to_orient(gt.ROW)
        Aj = gb.transpose(Aj).to_orient(gb.ROW)
        want = gb.extract(gb.transpose(Aj).to_orient(gb.ROW), I4, J4,
                          C=Cj.dup(), mask=Mj)
    else:
        want = gb.extract(Aj, I4, J4, C=Cj.dup(), mask=Mj,
                          desc=gb.Descriptor(**kw))
    got = gt.extract(At, I4, J4, C=Ct.dup(), mask=Mt,
                     desc=gt.Descriptor(**kw))
    assert_same(want, got)


@pytest.mark.parametrize("dt", [np.uint64, np.int8, np.bool_, np.complex64])
def test_extract_types(rng, dt):
    Aj, At = typed_pair(rng, SHAPE, 0.3, dt, which=8)
    assert_same(gb.extract(Aj, I4, J4), gt.extract(At, I4, J4))
    if dt == np.uint64:
        v = dense_port(gt.extract(At, I4, J4))[0]
        assert (v >= np.uint64(1 << 63)).any() and \
            (v[v != 0] < np.uint64(1 << 63)).any()


def test_extract_vector(rng):
    uj, ut = typed_pair(rng, (30, 1), 0.5, np.float64, klass=gb.Vector,
                        which=9)
    I = [0, 4, 7, 7, 29]
    got = gt.extract(ut, I, None)
    assert isinstance(got, gt.Vector)
    v, p = (np.asarray(x) for x in uj.to_dense_pair())
    gv, gp = dense_port(got)
    np.testing.assert_array_equal(gp, p[I])
    np.testing.assert_array_equal(gv[gp], v[I][gp])
    assert_same(gb.extract(uj, I[:4], None), gt.extract(ut, I[:4], None))


def test_extract_out_of_range(rng):
    _, At = typed_pair(rng, SHAPE, 0.3, np.float64, which=1)
    with pytest.raises(gt.errors.IndexOutOfBounds):
        gt.extract(At, [30], [0])


# ---- assign / subassign -----------------------------------------------------

IR, JR = [1, 4, 7, 20], [0, 2, 5, 9, 18]


@pytest.mark.parametrize("orient", ["row", "col"])
@pytest.mark.parametrize("cfmt", FORMATS)
def test_subassign_matrix(rng, cfmt, orient):
    Cj, Ct = typed_pair(rng, SHAPE, 0.3, np.float64, cfmt, orient, which=10)
    Aj, At = typed_pair(rng, (4, 5), 0.5, np.float64, which=11)
    assert_same(gb.subassign(Cj.dup(), Aj, IR, JR),
                gt.subassign(Ct.dup(), At, IR, JR))


def test_subassign_accum_mask(rng):
    Cj, Ct = typed_pair(rng, SHAPE, 0.35, np.float64, which=12)
    Aj, At = typed_pair(rng, (4, 5), 0.6, np.float64, which=11)
    Mj, Mt = mask_pair(rng, (4, 5), 13)
    jp, tp = _ops("PLUS")
    assert_same(gb.subassign(Cj.dup(), Aj, IR, JR, mask=Mj, accum=jp),
                gt.subassign(Ct.dup(), At, IR, JR, mask=Mt, accum=tp))


@pytest.mark.parametrize("desc", ["none", "replace", "complement",
                                  "structure"])
def test_assign_global_mask(rng, desc):
    Cj, Ct = typed_pair(rng, SHAPE, 0.35, np.float64, which=14)
    Aj, At = typed_pair(rng, (4, 5), 0.6, np.float64, which=11)
    Mj, Mt = mask_pair(rng, SHAPE, 15)
    kw = {"none": {}, "replace": dict(replace=True),
          "complement": dict(mask_complement=True),
          "structure": dict(mask_structure=True)}[desc]
    jm, tm = _ops("MINUS")
    assert_same(gb.assign(Cj.dup(), Aj, IR, JR, mask=Mj, accum=jm,
                          desc=gb.Descriptor(**kw)),
                gt.assign(Ct.dup(), At, IR, JR, mask=Mt, accum=tm,
                          desc=gt.Descriptor(**kw)))


@pytest.mark.parametrize("cfmt", ["sparse", "bitmap"])
def test_assign_global_mask_dense(rng, cfmt):
    """The dense splice and restore (BITMAP C or a BITMAP mask)."""
    Cj, Ct = typed_pair(rng, SHAPE, 0.35, np.float64, cfmt, which=14)
    Aj, At = typed_pair(rng, (4, 5), 0.6, np.float64, which=11)
    Mj, _ = mask_pair(rng, SHAPE, 15)
    Mj = Mj.to_format(gb.BITMAP)
    assert_same(gb.assign(Cj.dup(), Aj, IR, JR, mask=Mj),
                gt.assign(Ct.dup(), At, IR, JR, mask=to_port(Mj)))


@pytest.mark.parametrize("kind", ["subassign", "assign"])
def test_assign_scalar_region(rng, kind):
    Cj, Ct = typed_pair(rng, SHAPE, 0.3, np.int32, which=16)
    assert_same(getattr(gb, kind)(Cj.dup(), 5.7, IR, JR),
                getattr(gt, kind)(Ct.dup(), 5.7, IR, JR))
    assert_same(getattr(gb, kind)(Cj.dup(), -3, IR, JR),
                getattr(gt, kind)(Ct.dup(), gt.Scalar.from_value(-3), IR,
                                  JR))


@pytest.mark.parametrize("mask", ["values", "structure", "hyper"])
def test_assign_scalar_mask_fast_path(rng, mask):
    """C<M> = x over ALL (the reference's Method 05d): the mask's explicit
    false values select nothing unless it is structural."""
    Cj, Ct = typed_pair(rng, SHAPE, 0.1, np.float64, which=17)
    Mj, Mt = mask_pair(rng, SHAPE, 18)
    if mask == "hyper":
        Mj, Mt = Mj.to_format(gb.HYPER), Mt.to_format(gt.HYPER)
    kw = dict(mask_structure=True) if mask == "structure" else {}
    want = gb.assign(Cj.dup(), 3.25, mask=Mj, desc=gb.Descriptor(**kw))
    got = gt.assign(Ct.dup(), 3.25, mask=Mt, desc=gt.Descriptor(**kw))
    assert got.fmt in ("sparse", "hyper")
    assert_same(want, got)


def test_assign_vector(rng):
    vj, vt = typed_pair(rng, (6, 1), 0.5, np.float64, klass=gb.Vector,
                        which=19)
    wj, wt = typed_pair(rng, (3, 1), 0.9, np.float64, klass=gb.Vector,
                        which=20)
    assert_same(gb.subassign(vj.dup(), wj, [0, 2, 4], [0]),
                gt.subassign(vt.dup(), wt, [0, 2, 4], [0]))


@pytest.mark.parametrize("dt", [np.uint64, np.uint16, np.complex128])
def test_assign_types(rng, dt):
    """Values move through the signed views (UINT64 across 2^63), the
    accum op through the carriers."""
    Cj, Ct = typed_pair(rng, SHAPE, 0.35, dt, which=21)
    Aj, At = typed_pair(rng, (4, 5), 0.6, dt, which=11)
    Mj, Mt = mask_pair(rng, (4, 5), 13)
    jp, tp = _ops("PLUS")
    assert_same(gb.subassign(Cj.dup(), Aj, IR, JR, mask=Mj, accum=jp),
                gt.subassign(Ct.dup(), At, IR, JR, mask=Mt, accum=tp))
    Cb_j, Cb_t = Cj.to_format(gb.BITMAP), Ct.to_format(gt.BITMAP)
    assert_same(gb.subassign(Cb_j, Aj, IR, JR),
                gt.subassign(Cb_t, At, IR, JR))
    big = dt(np.iinfo(dt).max - 5) if dt != np.complex128 else dt(2.5)
    Mfj, Mft = mask_pair(rng, SHAPE, 18)
    assert_same(gb.assign(Cj.dup(), big, mask=Mfj),
                gt.assign(Ct.dup(), big, mask=Mft))


def test_assign_shape_mismatch(rng):
    _, Ct = typed_pair(rng, SHAPE, 0.3, np.float64, which=10)
    _, At = typed_pair(rng, (5, 4), 0.5, np.float64, which=22)
    with pytest.raises(gt.errors.DimensionMismatch, match="transposed"):
        gt.subassign(Ct, At, IR, JR)

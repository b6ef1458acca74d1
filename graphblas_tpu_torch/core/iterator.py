"""GxB_Iterator equivalents (counterpart of ``graphblas_tpu.core.iterator``;
reference: Include/GraphBLAS.h:11011-11125, Source/GB_Iterator_*.c —
attach/seek/next as static-inline functions over the 4 formats).

A device round trip per entry would be absurd: each iterator waits on the
matrix, moves its coordinates to the host once, and then iterates there —
the same amortised cost as the reference's pointer chasing, the same API
shape."""

from __future__ import annotations


from .types import host as _host


class EntryIterator:
    """Iterate (i, j, value) over stored entries in storage order
    (GxB_Matrix_Iterator / rowIterator / colIterator)."""

    def __init__(self, A):
        r, c, v = A.wait().coo()
        self._r, self._c, self._v = _host(r), _host(c), _host(v)
        self._pos = 0

    # -- GxB-style cursor API --------------------------------------------

    @property
    def pmax(self) -> int:
        return len(self._r)

    def seek(self, p: int) -> bool:
        """Position the cursor; returns False if exhausted."""
        self._pos = int(p)
        return self._pos < len(self._r)

    def next(self) -> bool:
        self._pos += 1
        return self._pos < len(self._r)

    def getrow(self) -> int:
        return int(self._r[self._pos])

    def getcol(self) -> int:
        return int(self._c[self._pos])

    def getvalue(self):
        return self._v[self._pos][()]

    # -- pythonic protocol -------------------------------------------------

    def __iter__(self):
        for i in range(len(self._r)):
            yield int(self._r[i]), int(self._c[i]), self._v[i][()]


class RowIterator:
    """Iterate rows, then entries within a row (GxB_rowIterator_*)."""

    def __init__(self, A):
        from .matrix import ROW, SPARSE
        S = A.wait().to_format(SPARSE, ROW)
        self._indptr = _host(S.indptr)
        self._indices = _host(S.indices)
        self._values = _host(S._vals_expanded())
        self.nrows = A.nrows

    def row(self, i: int):
        """(col_indices, values) of row i."""
        lo, hi = self._indptr[i], self._indptr[i + 1]
        return self._indices[lo:hi], self._values[lo:hi]

    def __iter__(self):
        for i in range(self.nrows):
            yield i, *self.row(i)


class ColIterator:
    """Iterate columns, then entries within a column (GxB_colIterator_*)."""

    def __init__(self, A):
        from .matrix import COL, SPARSE
        S = A.wait().to_format(SPARSE, COL)
        self._indptr = _host(S.indptr)
        self._indices = _host(S.indices)
        self._values = _host(S._vals_expanded())
        self.ncols = A.ncols

    def col(self, j: int):
        """(row_indices, values) of column j."""
        lo, hi = self._indptr[j], self._indptr[j + 1]
        return self._indices[lo:hi], self._values[lo:hi]

    def __iter__(self):
        for j in range(self.ncols):
            yield j, *self.col(j)

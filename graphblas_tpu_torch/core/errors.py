"""GraphBLAS error model (the port's copy of ``graphblas_tpu.core.errors``).

The reference returns ``GrB_Info`` codes from its API functions (reference:
Source/GrB_error.c); in Python the idiomatic equivalent is an exception
hierarchy with the same taxonomy and names, so errors map 1:1 between the
JAX package and this port.
"""

from __future__ import annotations


class GraphBLASError(Exception):
    """Base class for all GraphBLAS errors (== any non-SUCCESS GrB_Info)."""

    info = "GrB_PANIC"


# --- API errors (reference: Include/GraphBLAS.h GrB_Info enum) -------------

class UninitializedObject(GraphBLASError):
    info = "GrB_UNINITIALIZED_OBJECT"


class NullPointer(GraphBLASError):
    info = "GrB_NULL_POINTER"


class InvalidValue(GraphBLASError):
    info = "GrB_INVALID_VALUE"


class InvalidIndex(GraphBLASError):
    info = "GrB_INVALID_INDEX"


class DomainMismatch(GraphBLASError):
    info = "GrB_DOMAIN_MISMATCH"


class DimensionMismatch(GraphBLASError):
    info = "GrB_DIMENSION_MISMATCH"


class OutputNotEmpty(GraphBLASError):
    info = "GrB_OUTPUT_NOT_EMPTY"


class NotImplementedYet(GraphBLASError):
    info = "GrB_NOT_IMPLEMENTED"


class EmptyObject(GraphBLASError):
    info = "GrB_EMPTY_OBJECT"


# --- execution errors -------------------------------------------------------

class IndexOutOfBounds(GraphBLASError):
    info = "GrB_INDEX_OUT_OF_BOUNDS"


class OutOfMemory(GraphBLASError):
    info = "GrB_OUT_OF_MEMORY"


class InsufficientSpace(GraphBLASError):
    info = "GrB_INSUFFICIENT_SPACE"


class InvalidObject(GraphBLASError):
    info = "GrB_INVALID_OBJECT"


class NoValue(GraphBLASError, KeyError):
    """Entry not present (GrB_NO_VALUE from extractElement)."""

    info = "GrB_NO_VALUE"

"""graphblas_tpu_torch — the PyTorch/CUDA port of graphblas_tpu.

The GraphBLAS object model (13 types, the 1553 named semirings in
``names``, non-blocking pending updates), the SpMV main path (build ->
mxv/vxm over plus-times, min-plus and lor-land with mask and accum -> CSC
-> PageRank, BFS, SSSP), eWise add/mult/union, sparse x sparse mxm
(the SELL ESC engine, masked SpGEMM, triangle counting), the rest of the
op layer (extract, assign/subassign, kronecker, concat/split, diag,
resize/reshape, sort, serialize, Matrix Market input) and the @GrB
operator sugar (``A[I, J]``, ``A[M] = x``, ``A + B``, ``A @ v``) on torch
tensors, with hand-written Hopper (sm_90a) CUDA kernels for the SpMV hot
path (``csrc/spmv.cu``) and the SpGEMM sort-reduce
(``csrc/sortreduce.cu``).  The JAX package
``graphblas_tpu`` is the reference this port is tested against; this
package never imports it or JAX.

Every constructor takes ``device=``; without it tensors go to the card
(the ``device`` option, "cuda"), and a constructor raises where there is
no card rather than land on the CPU.  ``set_option("device", "cpu")`` or
``device="cpu"`` asks for the CPU.  Every op runs on its operands'
device.  On a CUDA tensor a kernel wrapper launches its
kernel or raises; on a CPU tensor it runs the kernel's plain torch
version.  ``set_option("kernels_enabled", False)`` selects the plain
torch tier everywhere.
"""

from . import api
from .core import config as _cfg
from .core import context as context
from .core import descriptor, errors, monoid, semiring, types
from .core import names as names
from .core import ops as operators
from .core.config import (burble, finalize, get_option, init, set_option,
                          trace_counters, trace_records, trace_reset)
from .core.context import Context
from .core.descriptor import Descriptor
from .core.matrix import (BITMAP, COL, FULL, HYPER, ROW, SPARSE, Matrix,
                          Scalar, Vector)
from .core.monoid import Monoid, monoid as make_monoid
from .core.ops import (BinaryOp, IndexUnaryOp, UnaryOp, binary_op,
                       index_unary_op, unary_op)
from .core.names import lookup as lookup_name
from .core.semiring import Semiring, semiring as make_semiring
from .api import (apply, assign, concat, deserialize, diag, ewise_add,
                  ewise_mult, ewise_union, extract, kronecker, mxm,
                  mxm_reduce_scalar, mxv, reduce, reduce_scalar, select,
                  serialize, sort, split, subassign, transpose, vector_diag,
                  vxm, vxm_chain)
from .algorithms import (bfs_parents, connected_components, sssp_grb,
                         triangle_count)

__version__ = "0.1.0"

// Hand-written Hopper (sm_90a) SpMV kernels for graphblas_tpu_torch.
//
// Two kernels, both over CSR arrays in device memory:
//
//   spmv_rowwarp_f32   y = A x, plus-times fp32, no plan.  Replaces the TPU
//                      kernel graphblas_tpu/kernels/spmv_onehot.py:spmv
//                      (bucket-grid one-hot MXU matmuls, _kernel/_run_inner).
//   spmv_planned<T, ADD, MUL>
//                      y_sub = A (ADD.MUL) x over the rows and sub-rows of an
//                      SpmvRoutePlan (kernels/spmv_route.py).  Replaces
//                      graphblas_tpu/kernels/spmv_route.py: spmv_route
//                      (<float, plus, times>), spmv_route_monoid (the 15
//                      <float, {min,max,plus} x {times,plus,first,second,
//                      pair}>) and spmv_route_ds (<double, plus, times>).
//
// What bounds them: SpMV does 2 flops per nonzero and moves ~12 bytes per
// nonzero (4 B column index + 4 B value + a 4 B gather of x; 8 B more for
// fp64), so on an H100 (3.35 TB/s HBM) it is bound by device-memory bytes,
// never by arithmetic.  The TPU kernels spent their design on the missing
// hardware gather (Benes/Clos routes, one-hot matmuls, bf16 hi/lo splits,
// double-single fp64); Hopper gathers x natively, has fp64 units and a
// 50 MB L2 that holds x at the bench size (4 MB), so the design here is the
// plain one: one warp per (sub-)row, lanes stride over the row's nonzeros
// with coalesced loads of indices and values, x read through the read-only
// path, and a warp-shuffle reduce in registers.  The plan's row split keeps
// a power-law hub row from serializing one warp, and its nnz-balanced
// blocks keep every CTA's work about equal.  Sub-row partials are combined
// by the caller (no float atomics here), so a result is deterministic.
//
// Every launcher returns cudaGetLastError() and launches on the stream it
// is given; it allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;

enum AddOp : int { ADD_PLUS = 0, ADD_MIN = 1, ADD_MAX = 2 };
enum MulOp : int {
  MUL_TIMES = 0, MUL_PLUS = 1, MUL_FIRST = 2, MUL_SECOND = 3, MUL_PAIR = 4
};

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// ADD monoids.  min/max propagate NaN, as torch's amin/amax (the plain
// versions) and jnp.minimum/maximum (the TPU kernels) do.
template <typename T, int ADD> struct Add;
template <typename T> struct Add<T, ADD_PLUS> {
  __device__ __forceinline__ static T ident() { return T(0); }
  __device__ __forceinline__ static T op(T a, T b) { return a + b; }
};
template <typename T> struct Add<T, ADD_MIN> {
  __device__ __forceinline__ static T ident() { return pos_inf<T>(); }
  __device__ __forceinline__ static T op(T a, T b) {
    return (a != a || a < b) ? a : b;
  }
};
template <typename T> struct Add<T, ADD_MAX> {
  __device__ __forceinline__ static T ident() { return -pos_inf<T>(); }
  __device__ __forceinline__ static T op(T a, T b) {
    return (a != a || a > b) ? a : b;
  }
};

// MUL(x_k, a_ik), argument order as MULT_FNS in the TPU package:
// first = the A value, second = the x value, pair = 1.
template <typename T, int MUL> struct Mul;
template <typename T> struct Mul<T, MUL_TIMES> {
  static constexpr bool kX = true, kA = true;
  __device__ __forceinline__ static T op(T x, T a) { return x * a; }
};
template <typename T> struct Mul<T, MUL_PLUS> {
  static constexpr bool kX = true, kA = true;
  __device__ __forceinline__ static T op(T x, T a) { return x + a; }
};
template <typename T> struct Mul<T, MUL_FIRST> {
  static constexpr bool kX = false, kA = true;
  __device__ __forceinline__ static T op(T, T a) { return a; }
};
template <typename T> struct Mul<T, MUL_SECOND> {
  static constexpr bool kX = true, kA = false;
  __device__ __forceinline__ static T op(T x, T) { return x; }
};
template <typename T> struct Mul<T, MUL_PAIR> {
  static constexpr bool kX = false, kA = false;
  __device__ __forceinline__ static T op(T, T) { return T(1); }
};

template <typename T, int ADD>
__device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = Add<T, ADD>::op(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// K2 twin: one warp per row, warps grid-strided over the rows.
__global__ void __launch_bounds__(kThreads)
spmv_rowwarp_f32_kernel(const int32_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const float* __restrict__ values,
                        const float* __restrict__ x,
                        float* __restrict__ y, int64_t m) {
  const int lane = threadIdx.x % kWarp;
  const int64_t nwarps = int64_t(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock +
                     threadIdx.x / kWarp;
       row < m; row += nwarps) {
    const int64_t p1 = indptr[row + 1];
    float acc = 0.0f;
    for (int64_t p = indptr[row] + lane; p < p1; p += kWarp) {
      acc += values[p] * __ldg(&x[indices[p]]);
    }
    acc = warp_reduce<float, ADD_PLUS>(acc);
    if (lane == 0) y[row] = acc;
  }
}

// K1/K3/K4 twin: block b owns sub-rows [block_ptr[b], block_ptr[b+1]);
// its warps stride over them, one warp per sub-row.  An empty sub-row
// stores ADD's identity.
template <typename T, int ADD, int MUL>
__global__ void __launch_bounds__(kThreads)
spmv_planned_kernel(const int32_t* __restrict__ sub_start,
                    const int32_t* __restrict__ sub_end,
                    const int32_t* __restrict__ block_ptr,
                    const int32_t* __restrict__ indices,
                    const T* __restrict__ values,
                    const T* __restrict__ x,
                    T* __restrict__ y_sub) {
  using A = Add<T, ADD>;
  using M = Mul<T, MUL>;
  const int lane = threadIdx.x % kWarp;
  const int r_end = block_ptr[blockIdx.x + 1];
  for (int r = block_ptr[blockIdx.x] + threadIdx.x / kWarp; r < r_end;
       r += kWarpsPerBlock) {
    const int64_t p1 = sub_end[r];
    T acc = A::ident();
    for (int64_t p = sub_start[r] + lane; p < p1; p += kWarp) {
      const T xv = M::kX ? __ldg(&x[indices[p]]) : T(0);
      const T av = M::kA ? values[p] : T(0);
      acc = A::op(acc, M::op(xv, av));
    }
    acc = warp_reduce<T, ADD>(acc);
    if (lane == 0) y_sub[r] = acc;
  }
}

struct PlannedArgs {
  const int32_t* sub_start;
  const int32_t* sub_end;
  const int32_t* block_ptr;
  int64_t nblocks;
  const int32_t* indices;
  const void* values;
  const void* x;
  void* y_sub;
  cudaStream_t stream;
};

template <typename T, int ADD, int MUL>
void launch_planned(const PlannedArgs& a) {
  spmv_planned_kernel<T, ADD, MUL>
      <<<static_cast<unsigned>(a.nblocks), kThreads, 0, a.stream>>>(
          a.sub_start, a.sub_end, a.block_ptr, a.indices,
          static_cast<const T*>(a.values), static_cast<const T*>(a.x),
          static_cast<T*>(a.y_sub));
}

template <int ADD>
bool launch_planned_f32(int64_t mul, const PlannedArgs& a) {
  switch (mul) {
    case MUL_TIMES: launch_planned<float, ADD, MUL_TIMES>(a); return true;
    case MUL_PLUS: launch_planned<float, ADD, MUL_PLUS>(a); return true;
    case MUL_FIRST: launch_planned<float, ADD, MUL_FIRST>(a); return true;
    case MUL_SECOND: launch_planned<float, ADD, MUL_SECOND>(a); return true;
    case MUL_PAIR: launch_planned<float, ADD, MUL_PAIR>(a); return true;
    default: return false;
  }
}

}  // namespace

extern "C" int gb_spmv_rowwarp_f32(const void* indptr, const void* indices,
                                   const void* values, const void* x,
                                   void* y, int64_t m, int64_t grid,
                                   void* stream) {
  if (m > 0 && grid > 0) {
    spmv_rowwarp_f32_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(values), static_cast<const float*>(x),
        static_cast<float*>(y), m);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float, 1 = double.  add/mul: the AddOp/MulOp codes.
extern "C" int gb_spmv_planned(int64_t dtype, int64_t add, int64_t mul,
                               const void* sub_start, const void* sub_end,
                               const void* block_ptr, int64_t nblocks,
                               const void* indices, const void* values,
                               const void* x, void* y_sub, void* stream) {
  const PlannedArgs a{static_cast<const int32_t*>(sub_start),
                      static_cast<const int32_t*>(sub_end),
                      static_cast<const int32_t*>(block_ptr),
                      nblocks,
                      static_cast<const int32_t*>(indices),
                      values, x, y_sub,
                      static_cast<cudaStream_t>(stream)};
  if (nblocks <= 0) return static_cast<int>(cudaGetLastError());
  bool ok = false;
  if (dtype == 0) {
    switch (add) {
      case ADD_PLUS: ok = launch_planned_f32<ADD_PLUS>(mul, a); break;
      case ADD_MIN: ok = launch_planned_f32<ADD_MIN>(mul, a); break;
      case ADD_MAX: ok = launch_planned_f32<ADD_MAX>(mul, a); break;
      default: ok = false;
    }
  } else if (dtype == 1 && add == ADD_PLUS && mul == MUL_TIMES) {
    launch_planned<double, ADD_PLUS, MUL_TIMES>(a);
    ok = true;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

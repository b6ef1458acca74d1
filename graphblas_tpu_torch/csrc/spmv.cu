// Hand-written Hopper (sm_90a) SpMV kernels for graphblas_tpu_torch.
//
// One merge-path design (Merrill & Garland, "Merge-based Parallel Sparse
// Matrix-Vector Multiplication", SC'16) serves every SpMV entry point:
//
//   spmv_merge_f32     y = A x, plus-times fp32, over the raw CSR arrays,
//                      no plan (K2).  Replaces the TPU kernel
//                      graphblas_tpu/kernels/spmv_onehot.py:spmv
//                      (bucket-grid one-hot MXU matmuls, _run_inner).
//   spmv_merge_planned<T, ADD, MUL>
//                      y = A (ADD.MUL) x with the tiles' start rows read
//                      from an SpmvRoutePlan (kernels/spmv_route.py).
//                      Replaces graphblas_tpu/kernels/spmv_route.py:
//                      spmv_route (K1, <float, plus, times>),
//                      spmv_route_monoid (K3, the 15 <float, {min,max,plus}
//                      x {times,plus,first,second,pair}>) and spmv_route_ds
//                      (K4, <double, plus, times>).
//   spmv_carry<T, ADD> the second pass of both: adds the partials of the
//                      rows cut between tiles to their rows, in tile order.
//
// What bounds them: SpMV does 2 operations per nonzero and must move 8 B
// per nonzero from device memory (4 B column index + 4 B value; 12 B in
// fp64) plus indptr, x and y once, so on an H100 (3.35 TB/s) it is bound
// by bytes, never by arithmetic.  The x gather adds one 32-byte L2 request
// per nonzero at random columns (x itself, 4 MB at n = 2^20, stays in the
// 50 MB L2), and the rate at which L2 serves those requests is what binds
// these kernels (chip_smoke.py phase 6: the same kernel with x in L1
// takes under half the time).  The
// row-per-warp kernels this replaces walked each row as three dependent
// round trips (indptr, then indices/values, then x) with nothing in flight
// behind them, left half the lanes idle on degree-16 rows, and gave a
// power-law hub row to one warp.
//
// The merge path: the CSR walk is the merge of the m row ends
// (indptr[1..m]) with the nnz nonzero positions, m + nnz steps; a step
// either takes a nonzero into the open row or ends it.  The path is cut
// into tiles of kTile steps, one per thread block, so every block has the
// same work whatever the row lengths (a run of empty rows costs a step
// each; a 40,000-nonzero row spans 20 blocks).  A tile's start (rows
// ended, nonzeros taken) lies on its diagonal; K2 finds it with a 32-way
// warp search of indptr, K1 reads it from the plan.  The block then
//   1. loads the tile's indices and values with 16-byte loads (4-byte
//      loads where the two arrays' alignments differ), issues all of its
//      x gathers before it uses any, and stores the products in shared
//      memory, beside the tile's row ends;
//   2. each thread finds its own start by a binary search in shared
//      memory and walks kItems steps, reducing its run of products in
//      registers and writing each row that ends after its first;
//   3. a segmented scan of the threads' open rows gives each thread the
//      partial of the row it started in (its first row to end); the row
//      open at the tile's end goes to a carry array, one entry a tile.
// spmv_carry then adds each run of carries for one row to that row, in
// tile order.  No float atomics: results are bitwise repeatable.
//
// Every launcher returns cudaGetLastError() and launches on the stream it
// is given; it allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kItems = 8;                      // path steps per thread
constexpr int kTile = kThreads * kItems;       // path steps per block
// 4-element (16-byte) loads of each array a thread
constexpr int kChunks = (kTile / 4 + kThreads - 1) / kThreads;
constexpr unsigned kFull = 0xffffffffu;

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

// Four consecutive elements from a 16-byte-aligned address.
__device__ __forceinline__ void load4(const int32_t* p, int32_t (&o)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Rows the merge path has ended after d steps: the first row x in
// [max(0, d - nnz), min(d, m)] whose end step (indptr[x + 1] + x) is at
// or after d.  All lanes of one warp call it; each round probes 32 points
// and keeps the interval between the last probe before d and the next,
// so a search over 2^20 rows takes 5 dependent loads.
__device__ int64_t warp_path_search(const int32_t* __restrict__ indptr,
                                    int64_t d, int64_t m, int64_t nnz) {
  const int lane = threadIdx.x % kWarp;
  int64_t lo = d - nnz > 0 ? d - nnz : 0;
  int64_t hi = d < m ? d : m;
  while (lo < hi) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t p = lo + lane * step;
    const bool before = p < hi && int64_t(__ldg(indptr + p + 1)) + p < d;
    const int k = __popc(__ballot_sync(kFull, before));   // a prefix
    if (k == 0) {
      hi = lo;
    } else {
      const int64_t top = lo + k * step;
      lo += (k - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

// Stores MUL(x[idx[k]], val[k]) for k < nz in shared memory and returns
// where (s_buf: kTile + 4 elements, 16-byte aligned).  The loaded arrays
// are read with 16-byte loads from the first element at which they are all
// 16-byte aligned (`base`; 4-byte loads before it and for the last 0-3),
// or with 4-byte loads throughout where the indices and values reach that
// alignment at different elements.  Every x gather of a thread is issued
// before any product is formed.
template <typename T, int MUL>
__device__ __forceinline__ T* load_products(const int32_t* __restrict__ idx,
                                            const T* __restrict__ val,
                                            const T* __restrict__ x, int nz,
                                            T* s_buf) {
  using M = Mul<T, MUL>;
  const int tid = threadIdx.x;
  const uintptr_t lead = M::kX ? reinterpret_cast<uintptr_t>(idx)
      : M::kA ? reinterpret_cast<uintptr_t>(val) : 0;
  const int base = int((16 - (lead & 15)) & 15) /
                   (M::kX ? 4 : int(sizeof(T)));
  T* s_prod = s_buf + (4 - base) % 4;     // s_prod + base: 16-byte aligned
  const int b0 = base < nz ? base : nz;
  const bool vec = !(M::kX && M::kA) ||
                   (reinterpret_cast<uintptr_t>(val + b0) & 15) == 0;
  auto one = [&](int k) {
    const T xv = M::kX ? __ldg(x + __ldg(idx + k)) : T(0);
    const T av = M::kA ? __ldg(val + k) : T(0);
    s_prod[k] = M::op(xv, av);
  };
  if (!vec) {
#pragma unroll
    for (int i = 0; i < kTile / kThreads; ++i) {
      const int k = tid + i * kThreads;
      if (k < nz) one(k);
    }
    return s_prod;
  }
  const int nvec = (nz - b0) / 4;
  int32_t ii[kChunks][4] = {};
  T aa[kChunks][4] = {};
  T xx[kChunks][4] = {};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = b0 + 4 * (tid + c * kThreads);
    if (tid + c * kThreads < nvec) {
      if (M::kX) load4(idx + k, ii[c]);
      if (M::kA) load4(val + k, aa[c]);
    }
  }
  if (M::kX) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (tid + c * kThreads < nvec) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xx[c][e] = __ldg(x + ii[c][e]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = b0 + 4 * (tid + c * kThreads);
    if (tid + c * kThreads < nvec) {
      T p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = M::op(xx[c][e], aa[c][e]);
      store4(s_prod + k, p);
    }
  }
  const int tail = b0 + 4 * nvec;                  // nz - tail <= 3
  if (tid < b0) one(tid);
  if (tid < nz - tail) one(tail + tid);
  return s_prod;
}

// One tile of the merge path per block (see the note at the top).
// kPlanned: the tile's start and end rows come from tile_row; else from
// warp_path_search.  Writes y for every row that ends in the tile, and
// the partial of the row open at its end to carry_row/carry_val[tile].
template <typename T, int ADD, int MUL, bool kPlanned>
__global__ void __launch_bounds__(kThreads)
spmv_merge_kernel(const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ tile_row,
                  const int32_t* __restrict__ indices,
                  const T* __restrict__ values,
                  const T* __restrict__ x,
                  T* __restrict__ y,
                  int32_t* __restrict__ carry_row,
                  T* __restrict__ carry_val,
                  int64_t m, int64_t nnz) {
  using A = Add<T, ADD>;
  __shared__ int32_t s_end[kTile + 1];   // row ends - the tile's 1st nonzero
  __shared__ __align__(16) T s_buf[kTile + 4];
  __shared__ int32_t s_wkey[kWarps];
  __shared__ T s_wval[kWarps];
  __shared__ int64_t s_x[2];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int64_t b = blockIdx.x;
  const int64_t d0 = b * kTile;
  const int64_t d1 = d0 + kTile < m + nnz ? d0 + kTile : m + nnz;
  int64_t x0, x1;
  if (kPlanned) {
    x0 = __ldg(tile_row + b);
    x1 = __ldg(tile_row + b + 1);
  } else {
    if (warp < 2) {
      const int64_t r = warp_path_search(indptr, warp ? d1 : d0, m, nnz);
      if (lane == 0) s_x[warp] = r;
    }
    __syncthreads();
    x0 = s_x[0];
    x1 = s_x[1];
  }
  const int64_t y0 = d0 - x0;
  const int nrows = int(x1 - x0);                 // rows ending in the tile
  const int nz = int(d1 - x1 - y0);               // its nonzeros
  const int items = int(d1 - d0);

  // 1. row ends and products into shared memory
  for (int i = tid; i <= nrows; i += kThreads) {
    const int64_t r = x0 + 1 + i;
    s_end[i] = r <= m ? int32_t(int64_t(__ldg(indptr + r)) - y0) : nz;
  }
  const T* s_prod =
      load_products<T, MUL>(indices + y0, values + y0, x, nz, s_buf);
  __syncthreads();

  // 2. this thread's kItems steps, from its diagonal
  const int dt = tid * kItems < items ? tid * kItems : items;
  const int de = dt + kItems < items ? dt + kItems : items;
  int lo = dt - nz > 0 ? dt - nz : 0;
  int hi = dt < nrows ? dt : nrows;
  while (lo < hi) {
    const int p = (lo + hi) >> 1;
    if (s_end[p] <= dt - p - 1) lo = p + 1; else hi = p;
  }
  const int row0 = lo;
  int rx = lo, ry = dt - lo;
  int end = s_end[rx];
  T acc = A::ident(), first = A::ident();
  bool ended = false;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (dt + s < de) {
      if (ry < end) {
        acc = A::op(acc, s_prod[ry]);
        ++ry;
      } else {
        if (ended) y[x0 + rx] = acc; else first = acc;
        ended = true;
        acc = A::ident();
        end = s_end[++rx];
      }
    }
  }

  // 3. segmented scan of (open row, partial) over the block
  const int key = rx;
  T val = acc;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int k = __shfl_up_sync(kFull, key, off);
    const T v = __shfl_up_sync(kFull, val, off);
    if (lane >= off && k == key) val = A::op(v, val);
  }
  if (lane == kWarp - 1) {
    s_wkey[warp] = key;
    s_wval[warp] = val;
  }
  __syncthreads();
  int wk = -1;                                    // warps before this one
  T wv = A::ident();
  for (int j = 0; j < warp; ++j) {
    const int k = s_wkey[j];
    wv = k == wk ? A::op(wv, s_wval[j]) : s_wval[j];
    wk = k;
  }
  const int key0 = __shfl_sync(kFull, key, 0);
  int pk = __shfl_up_sync(kFull, key, 1);         // exclusive prefix
  T pv = __shfl_up_sync(kFull, val, 1);
  if (lane == 0) {
    pk = wk;
    pv = wv;
  } else if (pk == key0 && pk == wk) {
    pv = A::op(wv, pv);
  }
  if (ended) y[x0 + row0] = pk == row0 ? A::op(pv, first) : first;
  if (tid == kThreads - 1) {
    carry_row[b] = int32_t(x0 + key);
    carry_val[b] = key == key0 && key == wk ? A::op(wv, val) : val;
  }
}

// y[r] = ADD(carries of r in tile order, y[r]) for each row r < m that was
// open at the end of a tile: one thread per run of equal carry rows.
template <typename T, int ADD>
__global__ void __launch_bounds__(kThreads)
spmv_carry_kernel(const int32_t* __restrict__ carry_row,
                  const T* __restrict__ carry_val, T* __restrict__ y,
                  int64_t tiles, int64_t m) {
  using A = Add<T, ADD>;
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= tiles) return;
  const int32_t r = carry_row[b];
  if (r >= m || (b > 0 && carry_row[b - 1] == r)) return;
  T acc = carry_val[b];
  for (int64_t c = b + 1; c < tiles && carry_row[c] == r; ++c) {
    acc = A::op(acc, carry_val[c]);
  }
  y[r] = A::op(acc, y[r]);
}

struct MergeArgs {
  const int32_t* indptr;
  const int32_t* tile_row;
  const int32_t* indices;
  const void* values;
  const void* x;
  void* y;
  int32_t* carry_row;
  void* carry_val;
  int64_t m, nnz, tiles;
  cudaStream_t stream;
};

// Both passes: the merge-path kernel, then the carry kernel.
template <typename T, int ADD, int MUL, bool kPlanned>
void launch_merge(const MergeArgs& a) {
  if (a.tiles <= 0) return;
  spmv_merge_kernel<T, ADD, MUL, kPlanned>
      <<<static_cast<unsigned>(a.tiles), kThreads, 0, a.stream>>>(
          a.indptr, a.tile_row, a.indices, static_cast<const T*>(a.values),
          static_cast<const T*>(a.x), static_cast<T*>(a.y), a.carry_row,
          static_cast<T*>(a.carry_val), a.m, a.nnz);
  spmv_carry_kernel<T, ADD>
      <<<static_cast<unsigned>((a.tiles + kThreads - 1) / kThreads),
         kThreads, 0, a.stream>>>(a.carry_row,
                                  static_cast<const T*>(a.carry_val),
                                  static_cast<T*>(a.y), a.tiles, a.m);
}

template <int ADD>
bool launch_planned_f32(int64_t mul, const MergeArgs& a) {
  switch (mul) {
    case MUL_TIMES: launch_merge<float, ADD, MUL_TIMES, true>(a); return true;
    case MUL_PLUS: launch_merge<float, ADD, MUL_PLUS, true>(a); return true;
    case MUL_FIRST: launch_merge<float, ADD, MUL_FIRST, true>(a); return true;
    case MUL_SECOND:
      launch_merge<float, ADD, MUL_SECOND, true>(a); return true;
    case MUL_PAIR: launch_merge<float, ADD, MUL_PAIR, true>(a); return true;
    default: return false;
  }
}

int64_t tiles_of(int64_t m, int64_t nnz) {
  return (m + nnz + kTile - 1) / kTile;
}

}  // namespace

// K2: y = A x (plus-times fp32) over CSR arrays, both passes.
// carry_row/carry_val: scratch of ceil((m + nnz) / tile) entries; tile
// must be kTile.
extern "C" int gb_spmv_merge_f32(const void* indptr, const void* indices,
                                 const void* values, const void* x, void* y,
                                 void* carry_row, void* carry_val, int64_t m,
                                 int64_t nnz, int64_t tile, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const MergeArgs a{static_cast<const int32_t*>(indptr), nullptr,
                    static_cast<const int32_t*>(indices), values, x, y,
                    static_cast<int32_t*>(carry_row), carry_val, m, nnz,
                    tiles_of(m, nnz), static_cast<cudaStream_t>(stream)};
  launch_merge<float, ADD_PLUS, MUL_TIMES, false>(a);
  return static_cast<int>(cudaGetLastError());
}

// K1/K3/K4: y = A (add.mul) x with tile_row (ceil((m + nnz) / tile) + 1
// start rows) from the plan, both passes.  dtype: 0 = float, 1 = double;
// add/mul: the AddOp/MulOp codes (fp64 takes plus-times only).
extern "C" int gb_spmv_merge_planned(int64_t dtype, int64_t add, int64_t mul,
                                     const void* indptr, const void* tile_row,
                                     const void* indices, const void* values,
                                     const void* x, void* y, void* carry_row,
                                     void* carry_val, int64_t m, int64_t nnz,
                                     int64_t tile, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const MergeArgs a{static_cast<const int32_t*>(indptr),
                    static_cast<const int32_t*>(tile_row),
                    static_cast<const int32_t*>(indices), values, x, y,
                    static_cast<int32_t*>(carry_row), carry_val, m, nnz,
                    tiles_of(m, nnz), static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (dtype == 0) {
    switch (add) {
      case ADD_PLUS: ok = launch_planned_f32<ADD_PLUS>(mul, a); break;
      case ADD_MIN: ok = launch_planned_f32<ADD_MIN>(mul, a); break;
      case ADD_MAX: ok = launch_planned_f32<ADD_MAX>(mul, a); break;
      default: ok = false;
    }
  } else if (dtype == 1 && add == ADD_PLUS && mul == MUL_TIMES) {
    launch_merge<double, ADD_PLUS, MUL_TIMES, true>(a);
    ok = true;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

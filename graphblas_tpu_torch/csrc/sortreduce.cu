// Hand-written Hopper (sm_90a) sort-reduce kernels for graphblas_tpu_torch:
// the per-run sort + segmented monoid reduce behind the SELL SpGEMM engine
// (ops/spgemm_sell.py) and triangle counting.
//
// Layout contract (kernels/sortreduce.py): flat int32 key planes whose
// length is a multiple of C; slot p belongs to run p / C.  Each run is
// sorted ascending by key (lexicographically by (key, key2) for the wide
// entry), equal keys are combined under the add monoid, and the unique key
// is written at its group's LAST slot with SENTINEL (2^31-1) everywhere else;
// the monoid total sits at that slot.  Values at other slots are
// unspecified.  SENTINEL keys are pads and never kept.
//
// Entries and the TPU kernels they replace (graphblas_tpu/kernels/
// sortreduce.py):
//   gb_sort_reduce, no tokens, no key2    K5  sort_reduce_rows (_kernel_fn)
//   gb_sort_reduce, tokens                K6  sort_reduce_rows_tok
//                                             (_kernel_fn_tok): a group
//                                             is kept only if it holds a
//                                             product (token bit 2) and
//                                             its mask-token presence (bit
//                                             1) equals want_token
//   gb_sort_reduce, key2 (+/- tokens)     K8  sort_reduce_rows_wide
//                                             (_kernel_fn_wide)
//   gb_sort_pair1                         K7  sort_reduce_pair1
//                                             (_kernel_fn_pair1): keys pack
//                                             (rank << 23) | (j << 1) |
//                                             is_product; output is the
//                                             product count of each kept
//                                             group, 0 elsewhere
//
// Monoids implemented (the ``op`` code): for int32 and float values PLUS,
// TIMES, MIN, MAX; for bool carried in int32 (0/1) LOR, LAND, LXOR, EQ.
// MIN/MAX on floats are fminf/fmaxf (NaN loses, GraphBLAS omitnan).  The
// SELL engine routes any other monoid to the classic path by predicate.
//
// What bounds them on an H100: each slot is read once and written once,
// so the compulsory device-memory traffic is 16 B/slot for K5 (key + value
// in and out), 20 for K6 (+ token), 8 for K7 (key in, count out) and 28
// for K8 with tokens (two key planes, value, token in; two keys, value
// out); at 3.35 TB/s that is ~4.8 ns per 1000 slots for K5.  The sort
// itself (log2(C)*(log2(C)+1)/2 = 66 compare-exchange passes at C = 2048)
// runs in shared memory, so the design keeps every intermediate there:
// one thread block per C-slot run loads its planes once (coalesced),
// runs a bitonic network in shared memory, a Hillis-Steele segmented
// inclusive scan under the monoid (ping-pong buffers, log2(C) steps, the
// token bits OR-ed in the same pass), and writes the run-end extract
// once.  Shared-memory bandwidth and __syncthreads, not HBM, set the
// time at C = 2048; a warp-level sort (registers + shuffles) is the next
// step.  C up to 2048 fits the 48 KB static window; C = 8192 asks for
// dynamic shared memory above 48 KB with cudaFuncSetAttribute.
//
// Every launcher returns cudaGetLastError() and launches on the stream it
// is given; it allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int32_t kTwin = 1 << 20;      // K7: twin flag rides the count
constexpr int kMaxThreads = 512;

enum Op : int {
  OP_PLUS = 0, OP_TIMES = 1, OP_MIN = 2, OP_MAX = 3,
  OP_LOR = 4, OP_LAND = 5, OP_LXOR = 6, OP_EQ = 7
};

template <typename V, int OP> struct Mon;
// int32 arithmetic wraps modulo 2^32, as torch's int32 add/mul do
template <> struct Mon<int32_t, OP_PLUS> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  }
};
template <> struct Mon<int32_t, OP_TIMES> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) *
                                static_cast<uint32_t>(b));
  }
};
template <> struct Mon<int32_t, OP_MIN> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return a < b ? a : b;
  }
};
template <> struct Mon<int32_t, OP_MAX> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return a > b ? a : b;
  }
};
template <> struct Mon<int32_t, OP_LOR> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return (a != 0) | (b != 0);
  }
};
template <> struct Mon<int32_t, OP_LAND> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return (a != 0) & (b != 0);
  }
};
template <> struct Mon<int32_t, OP_LXOR> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return (a != 0) ^ (b != 0);
  }
};
template <> struct Mon<int32_t, OP_EQ> {
  __device__ __forceinline__ static int32_t op(int32_t a, int32_t b) {
    return (a != 0) == (b != 0);
  }
};
template <> struct Mon<float, OP_PLUS> {
  __device__ __forceinline__ static float op(float a, float b) {
    return a + b;
  }
};
template <> struct Mon<float, OP_TIMES> {
  __device__ __forceinline__ static float op(float a, float b) {
    return a * b;
  }
};
template <> struct Mon<float, OP_MIN> {
  __device__ __forceinline__ static float op(float a, float b) {
    return fminf(a, b);
  }
};
template <> struct Mon<float, OP_MAX> {
  __device__ __forceinline__ static float op(float a, float b) {
    return fmaxf(a, b);
  }
};

struct Planes {
  const int32_t* keys;
  const int32_t* keys2;   // K8 second key plane, or null
  const void* vals;
  const int32_t* toks;    // K6/K8 token plane (1 token, 2 product), or null
  int32_t* okeys;
  int32_t* okeys2;
  void* ovals;
  int C;
  int want_token;
};

__device__ __forceinline__ bool key_gt(const int32_t* sk, const int32_t* sk2,
                                       int a, int b) {
  const int32_t ka = sk[a], kb = sk[b];
  if (sk2 == nullptr) return ka > kb;
  return ka > kb || (ka == kb && sk2[a] > sk2[b]);
}

// Bitonic network over one run in shared memory: ascending by (sk, sk2),
// carrying sv (and st, sk2 when present).
template <typename V>
__device__ void bitonic_sort(int C, int32_t* sk, int32_t* sk2, V* sv,
                             int32_t* st) {
  const int half = C >> 1;
  for (int k = 2; k <= C; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1));
        const int hi = lo + j;
        const bool asc = (lo & k) == 0;
        const bool swap = asc ? key_gt(sk, sk2, lo, hi)
                              : key_gt(sk, sk2, hi, lo);
        if (swap) {
          const int32_t tk = sk[lo]; sk[lo] = sk[hi]; sk[hi] = tk;
          if (sk2 != nullptr) {
            const int32_t t2 = sk2[lo]; sk2[lo] = sk2[hi]; sk2[hi] = t2;
          }
          if (sv != nullptr) {
            const V tv = sv[lo]; sv[lo] = sv[hi]; sv[hi] = tv;
          }
          if (st != nullptr) {
            const int32_t tt = st[lo]; st[lo] = st[hi]; st[hi] = tt;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Segmented inclusive scan, Hillis-Steele with ping-pong buffers.  f bit 0
// marks a group start; higher bits (tokens) are OR-ed along with v.
// Returns the buffers holding the result in *v_out / *f_out.
template <typename V, typename Combine>
__device__ void segmented_scan(int C, V* v0, V* v1, int32_t* f0,
                               int32_t* f1, V** v_out, int32_t** f_out,
                               Combine comb) {
  V* vin = v0;
  V* vo = v1;
  int32_t* fin = f0;
  int32_t* fo = f1;
  for (int s = 1; s < C; s <<= 1) {
    for (int p = threadIdx.x; p < C; p += blockDim.x) {
      V v = vin[p];
      int32_t f = fin[p];
      if (p >= s && (f & 1) == 0) {
        v = comb(vin[p - s], v);
        f |= fin[p - s];
      }
      vo[p] = v;
      fo[p] = f;
    }
    __syncthreads();
    V* tv = vin; vin = vo; vo = tv;
    int32_t* tf = fin; fin = fo; fo = tf;
  }
  *v_out = vin;
  *f_out = fin;
}

// K5 / K6 / K8: one block per C-slot run.
template <typename V, int OP>
__global__ void __launch_bounds__(kMaxThreads)
sort_reduce_kernel(Planes pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = pl.C;
  const bool wide = pl.keys2 != nullptr;
  const bool tok = pl.toks != nullptr;
  int32_t* sk = reinterpret_cast<int32_t*>(smem);
  int32_t* f0 = sk + C;
  int32_t* f1 = f0 + C;
  int32_t* sk2 = wide ? f1 + C : nullptr;
  V* v0 = reinterpret_cast<V*>(f1 + (wide ? 2 * C : C));
  V* v1 = v0 + C;
  const int64_t base = int64_t(blockIdx.x) * C;
  const V* vals = static_cast<const V*>(pl.vals);
  for (int p = threadIdx.x; p < C; p += blockDim.x) {
    sk[p] = pl.keys[base + p];
    if (wide) sk2[p] = pl.keys2[base + p];
    v0[p] = vals[base + p];
    f0[p] = tok ? pl.toks[base + p] : 0;
  }
  __syncthreads();
  bitonic_sort<V>(C, sk, sk2, v0, f0);
  // group starts: bit 0; tokens move up one bit
  for (int p = threadIdx.x; p < C; p += blockDim.x) {
    const bool start = p == 0 || sk[p] != sk[p - 1] ||
                       (wide && sk2[p] != sk2[p - 1]);
    f0[p] = (f0[p] << 1) | (start ? 1 : 0);
  }
  __syncthreads();
  V* vr;
  int32_t* fr;
  segmented_scan<V>(C, v0, v1, f0, f1, &vr, &fr,
                    [](V a, V b) { return Mon<V, OP>::op(a, b); });
  V* ovals = static_cast<V*>(pl.ovals);
  for (int p = threadIdx.x; p < C; p += blockDim.x) {
    const int32_t k = sk[p];
    const bool end = p == C - 1 || k != sk[p + 1] ||
                     (wide && sk2[p] != sk2[p + 1]);
    bool keep = end && k != kSentinel;
    if (tok) {
      const int32_t t = fr[p] >> 1;
      keep = keep && (t & 2) != 0 && (t & 1) == pl.want_token;
    }
    pl.okeys[base + p] = keep ? k : kSentinel;
    if (wide) pl.okeys2[base + p] = keep ? sk2[p] : kSentinel;
    ovals[base + p] = vr[p];
  }
}

// K7: keys only; counts from group lengths, twin from adjacency.
__global__ void __launch_bounds__(kMaxThreads)
sort_pair1_kernel(const int32_t* __restrict__ keys,
                  int32_t* __restrict__ out, int C, int want_token) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sk = reinterpret_cast<int32_t*>(smem);
  int32_t* f0 = sk + C;
  int32_t* f1 = f0 + C;
  int32_t* v0 = f1 + C;
  int32_t* v1 = v0 + C;
  const int64_t base = int64_t(blockIdx.x) * C;
  for (int p = threadIdx.x; p < C; p += blockDim.x) sk[p] = keys[base + p];
  __syncthreads();
  bitonic_sort<int32_t>(C, sk, nullptr, nullptr, nullptr);
  for (int p = threadIdx.x; p < C; p += blockDim.x) {
    const int32_t k = sk[p];
    const bool start = p == 0 || k != sk[p - 1];
    // the mask token of (rank, j) is unique and sorts just before its
    // products: key - 1
    const bool twin = start && p != 0 && sk[p - 1] == k - 1;
    const bool prod = (k & 1) != 0 && k != kSentinel;
    v0[p] = (prod ? 1 : 0) + (twin ? kTwin : 0);
    f0[p] = start ? 1 : 0;
  }
  __syncthreads();
  int32_t* vr;
  int32_t* fr;
  segmented_scan<int32_t>(
      C, v0, v1, f0, f1, &vr, &fr,
      [](int32_t a, int32_t b) { return a + b; });
  for (int p = threadIdx.x; p < C; p += blockDim.x) {
    const int32_t k = sk[p];
    const bool end = p == C - 1 || k != sk[p + 1];
    const int32_t v = vr[p];
    const int32_t cnt = v & (kTwin - 1);
    const int has_twin = (v & kTwin) != 0 ? 1 : 0;
    const bool keep = end && k != kSentinel && (k & 1) != 0 && cnt > 0 &&
                      has_twin == want_token;
    out[base + p] = keep ? cnt : 0;
  }
}

int threads_for(int64_t C) {
  const int64_t t = C / 2;
  return static_cast<int>(t < kMaxThreads ? t : kMaxThreads);
}

template <typename K>
cudaError_t launch_with_smem(K kernel, int64_t nruns, int threads,
                             size_t smem, cudaStream_t stream,
                             const Planes& pl) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(nruns), threads, smem, stream>>>(pl);
  return cudaSuccess;
}

template <typename V, int OP>
cudaError_t launch_sr(const Planes& pl, int64_t nruns, cudaStream_t s) {
  const int64_t C = pl.C;
  const size_t smem = size_t(C) * (3 * sizeof(int32_t) +
                                   (pl.keys2 ? sizeof(int32_t) : 0) +
                                   2 * sizeof(V));
  return launch_with_smem(sort_reduce_kernel<V, OP>, nruns, threads_for(C),
                          smem, s, pl);
}

}  // namespace

// vdtype: 0 = int32 (bool carried as 0/1 int32), 1 = float32.
// op: the Op codes above.  keys2 / toks (and okeys2) may be null.
extern "C" int gb_sort_reduce(int64_t vdtype, int64_t op, const void* keys,
                              const void* keys2, const void* vals,
                              const void* toks, void* okeys, void* okeys2,
                              void* ovals, int64_t nruns, int64_t C,
                              int64_t want_token, void* stream) {
  if (nruns <= 0) return static_cast<int>(cudaGetLastError());
  if (C < 2 || (C & (C - 1)) != 0 ||
      (keys2 != nullptr) != (okeys2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl{static_cast<const int32_t*>(keys),
                  static_cast<const int32_t*>(keys2), vals,
                  static_cast<const int32_t*>(toks),
                  static_cast<int32_t*>(okeys), static_cast<int32_t*>(okeys2),
                  ovals, static_cast<int>(C), static_cast<int>(want_token)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (vdtype == 0) {
    switch (op) {
      case OP_PLUS: e = launch_sr<int32_t, OP_PLUS>(pl, nruns, s); break;
      case OP_TIMES: e = launch_sr<int32_t, OP_TIMES>(pl, nruns, s); break;
      case OP_MIN: e = launch_sr<int32_t, OP_MIN>(pl, nruns, s); break;
      case OP_MAX: e = launch_sr<int32_t, OP_MAX>(pl, nruns, s); break;
      case OP_LOR: e = launch_sr<int32_t, OP_LOR>(pl, nruns, s); break;
      case OP_LAND: e = launch_sr<int32_t, OP_LAND>(pl, nruns, s); break;
      case OP_LXOR: e = launch_sr<int32_t, OP_LXOR>(pl, nruns, s); break;
      case OP_EQ: e = launch_sr<int32_t, OP_EQ>(pl, nruns, s); break;
      default: break;
    }
  } else if (vdtype == 1) {
    switch (op) {
      case OP_PLUS: e = launch_sr<float, OP_PLUS>(pl, nruns, s); break;
      case OP_TIMES: e = launch_sr<float, OP_TIMES>(pl, nruns, s); break;
      case OP_MIN: e = launch_sr<float, OP_MIN>(pl, nruns, s); break;
      case OP_MAX: e = launch_sr<float, OP_MAX>(pl, nruns, s); break;
      default: break;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gb_sort_pair1(const void* keys, void* out, int64_t nruns,
                             int64_t C, int64_t want_token, void* stream) {
  if (nruns <= 0) return static_cast<int>(cudaGetLastError());
  if (C < 2 || (C & (C - 1)) != 0 || C > (int64_t(1) << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(C) * 5 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_pair1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sort_pair1_kernel<<<static_cast<unsigned>(nruns), threads_for(C), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(out),
      static_cast<int>(C), static_cast<int>(want_token));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

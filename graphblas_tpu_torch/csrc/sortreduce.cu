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
// C = 32768 (K5/K6 only; the top sort class of the fast SpGEMM tier,
// ops/spgemm_fast.py): a run of 32768 slots needs 640 KB in this layout
// (20 B a slot with tokens), and even key + value alone (256 KB) is over
// the 227 KB a block may have.  sort_reduce_cluster_kernel therefore runs
// one 32768-slot run on a CLUSTER of 4 thread blocks (Hopper's distributed
// shared memory): each block holds one quarter (8192 slots, 160 KB) in the
// layout above.  Bitonic stages with exchange distance j < 8192 stay inside
// a block; the three with j >= 8192 (k = 16384, j = 8192; k = 32768,
// j = 16384 and 8192) read the partner slot in the partner block through
// cluster.map_shared_rank, each thread writing only its own slots after a
// cluster barrier (both partners read before either writes).  Group starts
// and ends at a quarter's edge read the neighbour block's last or first
// key.  The segmented scan runs per block; each block then folds in the
// scan totals of the blocks before it, nearest first, up to the first one
// that holds a group start (one key may fill the whole run).  Bound: 16
// B/slot (K5) or 20 (K6) of device memory, as at smaller C; 120
// compare-exchange passes set the time.
//
// Every launcher returns cudaGetLastError() and launches on the stream it
// is given; it allocates nothing and does not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// C = 32768 (K5/K6): one run per cluster of kClusterBlocks blocks of kQ slots
// ---------------------------------------------------------------------------

constexpr int kClusterBlocks = 4;
constexpr int kQ = 8192;                       // slots a block holds
constexpr int kBigC = kClusterBlocks * kQ;     // 32768
constexpr int kCThreads = 1024;
constexpr int kPer = kQ / kCThreads;           // slots a thread owns

// A bitonic pass with exchange distance j < kQ: both partners in this
// block.  The direction bit comes from the slot's index in the whole run.
template <typename V>
__device__ void block_pass(int gbase, int k, int j, int32_t* sk, V* sv,
                           int32_t* st, bool tok) {
  for (int i = threadIdx.x; i < kQ / 2; i += kCThreads) {
    const int lo = 2 * i - (i & (j - 1));
    const int hi = lo + j;
    const bool asc = ((gbase + lo) & k) == 0;
    const int32_t a = sk[lo];
    const int32_t b = sk[hi];
    if (asc ? a > b : b > a) {
      sk[lo] = b;
      sk[hi] = a;
      const V tv = sv[lo]; sv[lo] = sv[hi]; sv[hi] = tv;
      if (tok) {
        const int32_t tt = st[lo]; st[lo] = st[hi]; st[hi] = tt;
      }
    }
  }
  __syncthreads();
}

// A bitonic pass with exchange distance j >= kQ: the partner of run slot
// g is g ^ j, the same local slot in block rank ^ (j / kQ).  Each thread
// reads the partners of its own slots, waits until every thread of the
// cluster has read, then writes only its own slots.
template <typename V>
__device__ void cluster_pass(cg::cluster_group& cluster,
                             unsigned rank, int k, int j, int32_t* sk,
                             V* sv, int32_t* st, bool tok) {
  const unsigned prank = rank ^ static_cast<unsigned>(j / kQ);
  const int32_t* pk = cluster.map_shared_rank(sk, prank);
  const V* pv = cluster.map_shared_rank(sv, prank);
  const int32_t* pt = cluster.map_shared_rank(st, prank);
  int32_t nk[kPer];
  V nv[kPer];
  int32_t nt[kPer];
  bool take[kPer];
  cluster.sync();                  // the previous pass is written everywhere
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int p = threadIdx.x + t * kCThreads;
    const int g = static_cast<int>(rank) * kQ + p;
    const int32_t ka = sk[p];
    const int32_t kb = pk[p];
    const bool lower = (g & j) == 0;
    const bool asc = (g & k) == 0;
    take[t] = (asc == lower) ? kb < ka : kb > ka;
    nk[t] = kb;
    nv[t] = take[t] ? pv[p] : V();
    nt[t] = (take[t] && tok) ? pt[p] : 0;
  }
  cluster.sync();                  // both partners have read
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    if (take[t]) {
      const int p = threadIdx.x + t * kCThreads;
      sk[p] = nk[t];
      sv[p] = nv[t];
      if (tok) st[p] = nt[t];
    }
  }
  __syncthreads();
}

// K5 / K6 at C = kBigC: blocks 4r..4r+3 (one cluster) hold run r.
template <typename V, int OP>
__global__ void __launch_bounds__(kCThreads, 1)
sort_reduce_cluster_kernel(Planes pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t s_prev_key;   // last key of the block before
  __shared__ int32_t s_next_key;   // first key of the block after
  __shared__ int s_have;           // a carry from earlier blocks exists
  __shared__ int32_t s_cf;         // its flag bits
  __shared__ V s_cv;               // its value
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const bool tok = pl.toks != nullptr;
  int32_t* sk = reinterpret_cast<int32_t*>(smem);
  int32_t* f0 = sk + kQ;
  int32_t* f1 = f0 + kQ;
  V* v0 = reinterpret_cast<V*>(f1 + kQ);
  V* v1 = v0 + kQ;
  const int gbase = static_cast<int>(rank) * kQ;
  const int64_t base =
      int64_t(blockIdx.x / kClusterBlocks) * kBigC + gbase;
  const V* vals = static_cast<const V*>(pl.vals);
  for (int p = threadIdx.x; p < kQ; p += kCThreads) {
    sk[p] = pl.keys[base + p];
    v0[p] = vals[base + p];
    f0[p] = tok ? pl.toks[base + p] : 0;
  }
  __syncthreads();
  for (int k = 2; k <= kBigC; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kQ) {
        cluster_pass<V>(cluster, rank, k, j, sk, v0, f0, tok);
      } else {
        block_pass<V>(gbase, k, j, sk, v0, f0, tok);
      }
    }
  }
  cluster.sync();                  // every quarter sorted and visible
  if (threadIdx.x == 0) {
    s_prev_key = rank > 0 ? *cluster.map_shared_rank(sk + kQ - 1, rank - 1)
                          : 0;
    s_next_key = rank + 1 < kClusterBlocks
                     ? *cluster.map_shared_rank(sk, rank + 1) : 0;
  }
  __syncthreads();
  // group starts: bit 0; tokens move up one bit
  for (int p = threadIdx.x; p < kQ; p += kCThreads) {
    const bool start = p == 0 ? (rank == 0 || sk[0] != s_prev_key)
                              : sk[p] != sk[p - 1];
    f0[p] = (f0[p] << 1) | (start ? 1 : 0);
  }
  __syncthreads();
  const auto comb = [](V a, V b) { return Mon<V, OP>::op(a, b); };
  V* vr;
  int32_t* fr;
  segmented_scan<V>(kQ, v0, v1, f0, f1, &vr, &fr, comb);
  cluster.sync();                  // every block's own scan is done
  if (threadIdx.x == 0) {
    // carry = fold of the earlier blocks' scan totals, nearest first, up
    // to and including the first that holds a group start
    int have = 0;
    V cv = V();
    int32_t cf = 0;
    for (int q = static_cast<int>(rank) - 1; q >= 0; --q) {
      const V qv = *cluster.map_shared_rank(vr + kQ - 1, q);
      const int32_t qf = *cluster.map_shared_rank(fr + kQ - 1, q);
      cv = have ? comb(qv, cv) : qv;
      cf |= qf;
      have = 1;
      if (qf & 1) break;
    }
    s_have = have;
    s_cv = cv;
    s_cf = cf;
  }
  cluster.sync();                  // all carries read before any fold
  if (s_have) {
    // slots before this block's first group start continue the carry's
    // group (no remote access after the barrier above)
    for (int p = threadIdx.x; p < kQ; p += kCThreads) {
      if ((fr[p] & 1) == 0) {
        vr[p] = comb(s_cv, vr[p]);
        fr[p] |= s_cf;
      }
    }
    __syncthreads();
  }
  V* ovals = static_cast<V*>(pl.ovals);
  for (int p = threadIdx.x; p < kQ; p += kCThreads) {
    const int32_t k = sk[p];
    const bool end = p == kQ - 1
                         ? (rank + 1 == kClusterBlocks || k != s_next_key)
                         : k != sk[p + 1];
    bool keep = end && k != kSentinel;
    if (tok) {
      const int32_t t = fr[p] >> 1;
      keep = keep && (t & 2) != 0 && (t & 1) == pl.want_token;
    }
    pl.okeys[base + p] = keep ? k : kSentinel;
    ovals[base + p] = vr[p];
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

// C = kBigC: clusters of kClusterBlocks blocks (cudaLaunchKernelEx with
// the cluster-dimension attribute), 160 KB of dynamic shared memory each.
template <typename V, int OP>
cudaError_t launch_cluster(const Planes& pl, int64_t nruns,
                           cudaStream_t s) {
  const auto kernel = sort_reduce_cluster_kernel<V, OP>;
  const size_t smem = size_t(kQ) * (3 * sizeof(int32_t) + 2 * sizeof(V));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nruns * kClusterBlocks));
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, pl);
}

template <typename V, int OP>
cudaError_t launch_sr(const Planes& pl, int64_t nruns, cudaStream_t s) {
  const int64_t C = pl.C;
  if (C == kBigC) {
    if (pl.keys2 != nullptr) return cudaErrorInvalidValue;  // no K8 here
    return launch_cluster<V, OP>(pl, nruns, s);
  }
  if (C > kQ) return cudaErrorInvalidValue;
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

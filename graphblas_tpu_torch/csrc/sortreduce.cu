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
// ops/spgemm_fast.py): sort_reduce_cluster_regs_kernel<V, OP, TOK>
// replaces the TPU kernels _kernel_fn (K5, sort_reduce_rows l.252) and
// _kernel_fn_tok (K6, sort_reduce_rows_tok l.465) of graphblas_tpu/
// kernels/sortreduce.py at that C.  One run is 128 KB of keys and values
// (160 KB with tokens) and the sort needs room to exchange, so a run takes
// a CLUSTER of 4 thread blocks (Hopper's distributed shared memory): 8192
// slots a block, 1024 threads, 8 consecutive slots a thread, held in
// registers (key, value, token) from the load to the store.
//
// What bounds it: 16 B/slot (K5) or 20 (K6) of device memory, each plane
// read and written once with 16-byte accesses (input loads 4-byte where a
// plane is not 16-byte aligned); the 120 bitonic stages of a 32768-slot
// run set the time.  They split by exchange distance j:
//   j < 8             42 stages  compare-exchange inside the thread
//   8 <= j < 256      50 stages  __shfl_xor_sync in layout A (the lane
//                                is slot bits 3-7)
//   256 <= j < 8192   25 stages  __shfl_xor_sync in layout B (the lane is
//                                slot bits 8-12), reached by one round
//                                trip through shared memory for each of
//                                the 7 merges (k >= 512) that have them
//   j >= 8192          3 stages  each block writes its slots into the
//                                partner's inbox (cluster.map_shared_rank)
//                                and compares with its own inbox
// The segmented scan runs in registers too: serially over a thread's 8
// slots, over the lanes with shuffles, then over the 32 warp totals (each
// warp scans them from shared memory); a block folds in the totals of the
// blocks before it, nearest first, up to the first that holds a group
// start (one key may fill the whole run).  Barriers a block: 14
// __syncthreads and 9 cluster barriers, 5 of them split into an early
// arrive and a late wait.  Shared memory holds two exchange buffers, the
// block's own (layout changes) and its inbox: 2 x 8192 slots x 8 B =
// 128 KB (K5) or x 12 B = 192 KB (K6), plus 0.5 KB of edge keys and scan
// totals.
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
// C = 32768 (K5/K6): one run per cluster of kClusterBlocks blocks of kQ slots,
// sorted and scanned in registers
// ---------------------------------------------------------------------------

constexpr int kClusterBlocks = 4;
constexpr int kQ = 8192;                       // slots a block holds
constexpr int kBigC = kClusterBlocks * kQ;     // 32768
constexpr int kP = 8;                          // slots a thread holds
constexpr int kCThreads = kQ / kP;
constexpr int kCWarps = kCThreads / 32;
constexpr int kWide = 256;                     // slot bits 8-12: B's lanes
constexpr int kChunks = kP / 4;                // 16-byte chunks a thread
constexpr unsigned kFull = 0xffffffffu;
static_assert(kP % 4 == 0 && kCWarps * kP == kWide && kCWarps <= 32,
              "layouts A and B below");

// Two register layouts of a block's kQ slots.  Thread (warp w, lane l)
// holds the kP consecutive slots from
//   A: (32 w + l) kP     slot bits below kP the register, the next 5 the
//                        lane, the rest the warp
//   B: l kWide + w kP    slot bits below kP the register, 8-12 the lane,
//                        the bits between the warp
// so a stage with kP <= j < kWide is a shuffle at lane distance j / kP in
// A, and one with kWide <= j < kQ a shuffle at lane distance j / kWide in B.
__device__ __forceinline__ int slot0_a() { return threadIdx.x * kP; }
__device__ __forceinline__ int slot0_b() {
  return (threadIdx.x & 31) * kWide + (threadIdx.x >> 5) * kP;
}

// The exchange buffers hold each plane as 16-byte chunks of 4 slots; chunk
// c sits at c ^ ((c >> 6) & 7) ^ ((c >> 3) & (kChunks - 1)), so that the 8
// lanes of one 128-bit shared-memory phase hit 8 different bank groups in
// both layouts.  A thread's chunks c0 .. c0 + kChunks - 1 (c0 a multiple
// of kChunks) sit at chunk_at(c0) ^ h.
__device__ __forceinline__ int chunk_at(int c) {
  return c ^ ((c >> 6) & 7) ^ ((c >> 3) & (kChunks - 1));
}

__device__ __forceinline__ int32_t as_bits(int32_t x) { return x; }
__device__ __forceinline__ int32_t as_bits(float x) {
  return __float_as_int(x);
}
template <typename T> __device__ __forceinline__ T from_bits(int32_t x);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(int32_t x) {
  return x;
}
template <> __device__ __forceinline__ float from_bits<float>(int32_t x) {
  return __int_as_float(x);
}

template <typename T>
__device__ __forceinline__ int4 pack4(const T (&x)[kP], int h) {
  return make_int4(as_bits(x[4 * h]), as_bits(x[4 * h + 1]),
                   as_bits(x[4 * h + 2]), as_bits(x[4 * h + 3]));
}

template <typename T>
__device__ __forceinline__ void unpack4(T (&x)[kP], int h, int4 a) {
  x[4 * h] = from_bits<T>(a.x);
  x[4 * h + 1] = from_bits<T>(a.y);
  x[4 * h + 2] = from_bits<T>(a.z);
  x[4 * h + 3] = from_bits<T>(a.w);
}

// A thread's kP slots of one plane, to and from an exchange buffer (this
// block's, or a cluster peer's through a mapped pointer).
template <typename T>
__device__ __forceinline__ void put_slots(int32_t* plane, int s0,
                                          const T (&x)[kP]) {
  int4* p = reinterpret_cast<int4*>(plane);
  const int c = chunk_at(s0 >> 2);
#pragma unroll
  for (int h = 0; h < kChunks; ++h) p[c ^ h] = pack4(x, h);
}

template <typename T>
__device__ __forceinline__ void get_slots(const int32_t* plane, int s0,
                                          T (&x)[kP]) {
  const int4* p = reinterpret_cast<const int4*>(plane);
  const int c = chunk_at(s0 >> 2);
#pragma unroll
  for (int h = 0; h < kChunks; ++h) unpack4(x, h, p[c ^ h]);
}

// kP consecutive elements of a device-memory plane: 16-byte accesses where
// the plane is 16-byte aligned (src - s0 is, since s0 % kP == 0), else
// 4-byte ones.
template <typename T>
__device__ __forceinline__ void load_slots(const T* src, T (&x)[kP]) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int h = 0; h < kChunks; ++h)
      unpack4(x, h, __ldcs(reinterpret_cast<const int4*>(src) + h));
  } else {
#pragma unroll
    for (int i = 0; i < kP; ++i) x[i] = src[i];
  }
}

// The output planes are 16-byte aligned (launch_cluster checks).
template <typename T>
__device__ __forceinline__ void store_slots(T* dst, const T (&x)[kP]) {
#pragma unroll
  for (int h = 0; h < kChunks; ++h)
    __stcs(reinterpret_cast<int4*>(dst) + h, pack4(x, h));
}

// A thread's slots: keys, values and (TOK) tokens; after the sort the
// token registers hold the scan flags.
template <typename V, bool TOK>
struct Tile {
  int32_t k[kP];
  V v[kP];
  int32_t t[kP];
};

template <typename V, bool TOK>
__device__ __forceinline__ void put_tile(int32_t* sk, int32_t* sv,
                                         int32_t* st, int s0,
                                         const Tile<V, TOK>& r) {
  put_slots(sk, s0, r.k);
  put_slots(sv, s0, r.v);
  if (TOK) put_slots(st, s0, r.t);
}

template <typename V, bool TOK>
__device__ __forceinline__ void get_tile(const int32_t* sk,
                                         const int32_t* sv,
                                         const int32_t* st, int s0,
                                         Tile<V, TOK>& r) {
  get_slots(sk, s0, r.k);
  get_slots(sv, s0, r.v);
  if (TOK) get_slots(st, s0, r.t);
}

// Keep the partner's slot i when it belongs here: the smaller key where
// keep_min, else the larger (equal keys stay, on both sides).  A min or
// max and selects, not branches: lanes disagree.
template <typename V, bool TOK>
__device__ __forceinline__ void keep(Tile<V, TOK>& r, int i, bool keep_min,
                                     int32_t kb, V vb, int32_t tb) {
  const int32_t ka = r.k[i];
  const int32_t nk = keep_min ? min(ka, kb) : max(ka, kb);
  const bool take = nk != ka;
  r.k[i] = nk;
  r.v[i] = take ? vb : r.v[i];
  if (TOK) r.t[i] = take ? tb : r.t[i];
}

// The stage (k, j) with its partner d lanes away.  g0 (the thread's first
// slot in the run) is a multiple of kP <= j, so all the thread's slots
// share their direction ((g & k) == 0: ascending) and side ((g & j) == 0:
// lower); the lower slot of an ascending pair keeps the smaller key.
template <typename V, bool TOK>
__device__ __forceinline__ void shfl_stage(Tile<V, TOK>& r, int g0, int k,
                                           int j, int d) {
  const bool keep_min = ((g0 & k) == 0) == ((g0 & j) == 0);
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int32_t kb = __shfl_xor_sync(kFull, r.k[i], d);
    const V vb = __shfl_xor_sync(kFull, r.v[i], d);
    const int32_t tb = TOK ? __shfl_xor_sync(kFull, r.t[i], d) : 0;
    keep(r, i, keep_min, kb, vb, tb);
  }
}

// The stages of merge k with j < kP, inside the thread.
template <typename V, bool TOK>
__device__ __forceinline__ void thread_stages(Tile<V, TOK>& r, int g0,
                                              int k) {
#pragma unroll
  for (int j = kP / 2; j > 0; j >>= 1) {
    if (j >= k) continue;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (i & j) continue;
      const int hi = i | j;
      const bool asc = ((g0 + i) & k) == 0;
      const int32_t a = r.k[i], b = r.k[hi];
      r.k[i] = asc ? min(a, b) : max(a, b);
      r.k[hi] = asc ? max(a, b) : min(a, b);
      const bool sw = r.k[i] != a;
      const V va = r.v[i], vb = r.v[hi];
      r.v[i] = sw ? vb : va;
      r.v[hi] = sw ? va : vb;
      if (TOK) {
        const int32_t ta = r.t[i], tb = r.t[hi];
        r.t[i] = sw ? tb : ta;
        r.t[hi] = sw ? ta : tb;
      }
    }
  }
}

// A stage with j >= kQ: the partner of run slot g is the same local slot
// in block rank ^ (j / kQ), which has written its slots into this block's
// inbox (ik, iv, it); this thread reads its own slots' places there.
template <typename V, bool TOK>
__device__ __forceinline__ void cluster_stage(Tile<V, TOK>& r,
                                              const int32_t* ik,
                                              const int32_t* iv,
                                              const int32_t* it, int g0,
                                              int s0, int k, int j) {
  const int4* pk = reinterpret_cast<const int4*>(ik);
  const int4* pv = reinterpret_cast<const int4*>(iv);
  const int4* pt = reinterpret_cast<const int4*>(it);
  const bool keep_min = ((g0 & k) == 0) == ((g0 & j) == 0);
  const int c = chunk_at(s0 >> 2);
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    const int4 a = pk[c ^ h];
    const int4 b = pv[c ^ h];
    const int4 t = TOK ? pt[c ^ h] : make_int4(0, 0, 0, 0);
    keep(r, 4 * h + 0, keep_min, a.x, from_bits<V>(b.x), t.x);
    keep(r, 4 * h + 1, keep_min, a.y, from_bits<V>(b.y), t.y);
    keep(r, 4 * h + 2, keep_min, a.z, from_bits<V>(b.z), t.z);
    keep(r, 4 * h + 3, keep_min, a.w, from_bits<V>(b.w), t.w);
  }
}

// Inclusive segmented scan over the 32 lanes of (v, f): f bit 0 marks a
// segment start, the higher bits are OR-ed along.
template <typename V, int OP>
__device__ __forceinline__ void warp_scan(V& v, int32_t& f, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V pv = __shfl_up_sync(kFull, v, o);
    const int32_t pf = __shfl_up_sync(kFull, f, o);
    if (lane >= o && (f & 1) == 0) {
      v = Mon<V, OP>::op(pv, v);
      f |= pf;
    }
  }
}

// The barrier of the whole cluster, split in two: a block arrives when it
// is done with what its peers may overwrite or free, and waits before it
// writes to a peer or exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// K5 / K6 at C = kBigC: blocks 4r..4r+3 (one cluster) hold run r.
template <typename V, int OP, bool TOK>
__global__ void __launch_bounds__(kCThreads, 1)
sort_reduce_cluster_regs_kernel(Planes pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t s_first[kCWarps];   // first key of each warp's slots
  __shared__ int32_t s_last[kCWarps];    // last key of each warp's slots
  __shared__ V s_wv[kCWarps];            // each warp's scan total
  __shared__ int32_t s_wf[kCWarps];
  __shared__ V s_bv;                     // the block's scan total, its
  __shared__ int32_t s_bf;               // first slot taken as no start
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // two exchange buffers: this block's own (transpositions) and its inbox
  // (the stages across the cluster); the token planes with TOK only
  int32_t* sk = reinterpret_cast<int32_t*>(smem);
  int32_t* sv = sk + kQ;
  int32_t* st = sv + kQ;
  int32_t* ik = sk + (TOK ? 3 : 2) * kQ;
  int32_t* iv = ik + kQ;
  int32_t* it = iv + kQ;
  const int gbase = static_cast<int>(rank) * kQ;
  const int sa = slot0_a();
  const int sb = slot0_b();
  const int ga = gbase + sa;
  const int gb = gbase + sb;
  const int64_t base =
      int64_t(blockIdx.x / kClusterBlocks) * kBigC + gbase + sa;
  cluster_arrive();            // a peer writes here only once all started
  Tile<V, TOK> r;
  load_slots(pl.keys + base, r.k);
  load_slots(static_cast<const V*>(pl.vals) + base, r.v);
  if (TOK) load_slots(pl.toks + base, r.t);

  // Merges k <= kQ stay in the block.  A thread writes and reads back only
  // its own slots' places in one layout, so a barrier is needed only
  // between a write in one layout and the read in the other.
  for (int k = 2; k <= kQ; k <<= 1) {
    if (k > kWide) {
      put_tile(sk, sv, st, sa, r);
      __syncthreads();
      get_tile(sk, sv, st, sb, r);
      for (int j = k >> 1; j >= kWide; j >>= 1)
        shfl_stage(r, gb, k, j, j / kWide);
      put_tile(sk, sv, st, sb, r);
      __syncthreads();
      get_tile(sk, sv, st, sa, r);
    }
    for (int j = min(k >> 1, kWide >> 1); j >= kP; j >>= 1)
      shfl_stage(r, ga, k, j, j / kP);
    thread_stages(r, ga, k);
  }
  // Merges across the cluster.  For each stage with j >= kQ a block writes
  // its slots into the partner's inbox (once the partner is done reading
  // it), and after a cluster barrier compares with what its own inbox
  // holds, in layout B; the first such stage of a merge also moves the
  // block's own slots from layout A to B.  Then layout B's stages, then A's.
  for (int k = 2 * kQ; k <= kBigC; k <<= 1) {
    put_tile(sk, sv, st, sa, r);
    for (int j = k >> 1; j >= kQ; j >>= 1) {
      const unsigned prank = rank ^ static_cast<unsigned>(j / kQ);
      cluster_wait();
      put_tile(cluster.map_shared_rank(ik, prank),
               cluster.map_shared_rank(iv, prank),
               TOK ? cluster.map_shared_rank(it, prank) : nullptr,
               j == k >> 1 ? sa : sb, r);
      cluster.sync();
      if (j == k >> 1) get_tile(sk, sv, st, sb, r);
      cluster_stage(r, ik, iv, it, gb, sb, k, j);
      cluster_arrive();
    }
    for (int j = kQ >> 1; j >= kWide; j >>= 1)
      shfl_stage(r, gb, k, j, j / kWide);
    put_tile(sk, sv, st, sb, r);
    __syncthreads();
    get_tile(sk, sv, st, sa, r);
    for (int j = kWide >> 1; j >= kP; j >>= 1)
      shfl_stage(r, ga, k, j, j / kP);
    thread_stages(r, ga, k);
  }

  // Group starts (flag bit 0; tokens move up one bit).  The block's first
  // slot is taken as no start here and settled against the block before
  // once the cluster has published its edges.
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_first[w] = r.k[0];
  if (lane == 31) s_last[w] = r.k[kP - 1];
  __syncthreads();
  int32_t prev = __shfl_up_sync(kFull, r.k[kP - 1], 1);
  if (lane == 0) prev = w > 0 ? s_last[w - 1] : r.k[0];
  int32_t next = __shfl_down_sync(kFull, r.k[0], 1);
  if (lane == 31 && w + 1 < kCWarps) next = s_first[w + 1];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int32_t pk = i > 0 ? r.k[i - 1] : prev;
    r.t[i] = (TOK ? r.t[i] << 1 : 0) | (r.k[i] != pk ? 1 : 0);
  }
  // inclusive segmented scan over the thread's slots, then its lanes
  const auto comb = [](V a, V b) { return Mon<V, OP>::op(a, b); };
#pragma unroll
  for (int i = 1; i < kP; ++i) {
    if ((r.t[i] & 1) == 0) {
      r.v[i] = comb(r.v[i - 1], r.v[i]);
      r.t[i] |= r.t[i - 1];
    }
  }
  V tv = r.v[kP - 1];
  int32_t tf = r.t[kP - 1];
  warp_scan<V, OP>(tv, tf, lane);
  const V lv = __shfl_up_sync(kFull, tv, 1);      // the lanes before
  const int32_t lf = __shfl_up_sync(kFull, tf, 1);
  if (lane == 31) {
    s_wv[w] = tv;
    s_wf[w] = tf;
  }
  __syncthreads();
  // every warp scans the warp totals: its prefix is lane w - 1's
  V wv = lane < kCWarps ? s_wv[lane] : V();
  int32_t wf = lane < kCWarps ? s_wf[lane] : 0;
  warp_scan<V, OP>(wv, wf, lane);
  const V pv = __shfl_sync(kFull, wv, (w + 31) & 31);
  const int32_t pf = __shfl_sync(kFull, wf, (w + 31) & 31);
  const V bv = __shfl_sync(kFull, wv, kCWarps - 1);
  const int32_t bf = __shfl_sync(kFull, wf, kCWarps - 1);
  if (threadIdx.x == 0) {
    s_bv = bv;
    s_bf = bf;
  }
  cluster_wait();
  cluster.sync();                        // edges and totals published

  // The carry: if this block's first slot continues the block before's
  // last group, the fold of the earlier blocks' totals, nearest first, up
  // to and including the first that holds a group start.
  bool have = false;
  V cv = V();
  int32_t cf = 0;
  if (rank > 0 &&
      s_first[0] == *cluster.map_shared_rank(&s_last[kCWarps - 1],
                                             rank - 1)) {
    for (int q = static_cast<int>(rank) - 1; q >= 0; --q) {
      const V qv = *cluster.map_shared_rank(&s_bv, q);
      int32_t qf = *cluster.map_shared_rank(&s_bf, q);
      if (q == 0 || *cluster.map_shared_rank(&s_first[0], q) !=
                        *cluster.map_shared_rank(&s_last[kCWarps - 1],
                                                 q - 1))
        qf |= 1;                         // block q's first slot starts
      cv = have ? comb(qv, cv) : qv;
      cf |= qf;
      have = true;
      if (qf & 1) break;
    }
  }
  const bool run_end = rank + 1 == kClusterBlocks &&
                       threadIdx.x == kCThreads - 1;
  if (threadIdx.x == kCThreads - 1 && !run_end)
    next = *cluster.map_shared_rank(&s_first[0], rank + 1);
  cluster_arrive();                      // no more reads of the peers

  // the thread's exclusive prefix: the carry, the warps before, the lanes
  // before, in that order
  const auto push = [&](bool h, V v, int32_t f) {
    if (!h) return;
    if (!have || (f & 1)) {
      cv = v;
      cf = f;
    } else {
      cv = comb(cv, v);
      cf |= f;
    }
    have = true;
  };
  push(w > 0, pv, pf);
  push(lane > 0, lv, lf);
  int32_t ok[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    if (have && (r.t[i] & 1) == 0) {
      r.v[i] = comb(cv, r.v[i]);
      r.t[i] |= cf;
    }
    const bool end = i + 1 < kP ? r.k[i] != r.k[i + 1]
                                : (run_end || r.k[i] != next);
    bool keep_it = end && r.k[i] != kSentinel;
    if (TOK) {
      const int32_t t = r.t[i] >> 1;
      keep_it = keep_it && (t & 2) != 0 && (t & 1) == pl.want_token;
    }
    ok[i] = keep_it ? r.k[i] : kSentinel;
  }
  store_slots(pl.okeys + base, ok);
  store_slots(static_cast<V*>(pl.ovals) + base, r.v);
  cluster_wait();
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
// the cluster-dimension attribute); the two exchange buffers are the
// dynamic shared memory, 128 KB (K5) or 192 KB (K6).
template <bool TOK>
constexpr size_t cluster_smem() {
  return size_t(kQ) * sizeof(int32_t) * (TOK ? 3 : 2) * 2;
}

// The kernel's shared-memory limit set, and its launch configuration for
// nruns runs (cfg.attrs points into attr).
template <typename K>
cudaError_t cluster_config(K kernel, size_t smem, int64_t nruns,
                           cudaStream_t s, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(nruns * kClusterBlocks));
  cfg->blockDim = dim3(kCThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename V, int OP, bool TOK>
cudaError_t launch_cluster_t(const Planes& pl, int64_t nruns,
                             cudaStream_t s) {
  const auto kernel = sort_reduce_cluster_regs_kernel<V, OP, TOK>;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const cudaError_t e =
      cluster_config(kernel, cluster_smem<TOK>(), nruns, s, attr, &cfg);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kernel, pl);
}

template <typename V, int OP>
cudaError_t launch_cluster(const Planes& pl, int64_t nruns,
                           cudaStream_t s) {
  if (((reinterpret_cast<uintptr_t>(pl.okeys) |
        reinterpret_cast<uintptr_t>(pl.ovals)) & 15) != 0)
    return cudaErrorInvalidValue;     // outputs take 16-byte stores
  return pl.toks != nullptr ? launch_cluster_t<V, OP, true>(pl, nruns, s)
                            : launch_cluster_t<V, OP, false>(pl, nruns, s);
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

// The C = 32768 kernel as launched for fp32 PLUS, with (tok != 0) or
// without the token plane: out[0] the most clusters the card holds at
// once (cudaOccupancyMaxActiveClusters), out[1] registers a thread,
// out[2] local memory a thread (spills), out[3] static and out[4] dynamic
// shared memory a block, in bytes.
extern "C" int gb_sort_reduce_cluster_info(int64_t tok, int32_t* out) {
  const auto kernel = tok ? sort_reduce_cluster_regs_kernel<float, OP_PLUS,
                                                            true>
                          : sort_reduce_cluster_regs_kernel<float, OP_PLUS,
                                                            false>;
  const size_t smem = tok ? cluster_smem<true>() : cluster_smem<false>();
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kernel, smem, 1, nullptr, attr, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = clusters;
  out[1] = fa.numRegs;
  out[2] = static_cast<int32_t>(fa.localSizeBytes);
  out[3] = static_cast<int32_t>(fa.sharedSizeBytes);
  out[4] = static_cast<int32_t>(smem);
  return 0;
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

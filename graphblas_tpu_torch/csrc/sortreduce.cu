// Hand-written Hopper (sm_90a) sort-reduce kernels for graphblas_tpu_torch:
// the per-run sort + segmented monoid reduce behind the SELL SpGEMM engine
// (ops/spgemm_sell.py), the fast SpGEMM tier (ops/spgemm_fast.py) and
// triangle counting.
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
// sortreduce.py), each at every C in {128, 512, 2048, 8192, 32768}:
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
// out); at 3.35 TB/s that is ~4.8 ns per 1000 slots for K5.  The bitonic
// network (log2(C) (log2(C) + 1) / 2 stages: 66 at C = 2048, 120 at 32768)
// sets the time, so every kernel keeps a thread's slots in registers from
// the load to the store: 8 consecutive slots a thread (key, value, token;
// K8 packs its two keys into one signed 64-bit key, K7 sorts keys alone
// and derives its counts after the sort).  The stages split by exchange
// distance j:
//   j < 8             compare-exchange inside the thread
//   8 <= j < 256      __shfl_xor_sync in layout A (the lane is slot bits
//                     3-7)
//   256 <= j < S      __shfl_xor_sync in layout B (the lane is the slot
//                     bits above a warp's stride), reached by one round
//                     trip through an XOR-swizzled shared-memory buffer
//                     for each merge that has such stages
//   j >= S            C = 32768 only: across the cluster (below)
// where S is the slots a block holds.  Compare-exchanges are min/max plus
// selects (two strict compares and selects for K8's 64-bit key; lanes
// disagree, and a branch costs more).  The segmented scan runs
// in registers too: serially over a thread's 8 slots, over the lanes with
// shuffles, then over the warp totals.  Loads and stores are 16 bytes a
// thread a plane (input loads 4-byte where a plane is not 16-byte
// aligned; the launchers refuse misaligned outputs).
//
// C <= 8192: sort_reduce_block_regs_kernel<V, OP, MODE, NW>.  A block of
// NW warps holds NW * 256 slots: 8 warps (2048 slots, four blocks an SM)
// at C <= 2048, 32 warps (8192 slots) at C = 8192.  Its NW * 256 / C runs
// are sorted side by side: the direction of merge k is (g & k) == 0 for
// the run slot g, ascending at k = C, and each run's first slot is a group
// start to the scan.  No cluster, no carry; runs past nruns are SENTINEL
// in registers and are not stored.  Shared memory holds one exchange
// buffer (none at C = 128).
//
// C = 32768: sort_reduce_cluster_regs_kernel<V, OP, MODE>.  One run is 128
// KB of keys and values (160 KB with tokens) and the sort needs room to
// exchange, so a run takes a CLUSTER of 4 thread blocks (Hopper's
// distributed shared memory) of 1024 threads and 8192 slots.  The 3 stages
// with j >= 8192 write the block's slots into the partner block's
// shared-memory inbox (cluster.map_shared_rank) and compare with its own
// inbox.  A block scans with its first slot taken as no group start and
// folds in the totals of the blocks before it, nearest first, up to the
// first that holds a group start (one key may fill the whole run); K7 also
// adds the twin of a group that starts at a block's first slot there.
// Barriers a block: 14 __syncthreads and 9 cluster barriers, 5 of them
// split into an early arrive and a late wait.  Shared memory holds two
// exchange buffers (the block's own, for layout changes, and its inbox):
// 2 x 8192 slots x 4 B a plane, 64 KB (K7) to 192 KB (K6, K8); K8 with
// tokens (4 planes, 256 KB in two) has one buffer that is both, and pays
// for it with a full cluster barrier before each cross-block stage.
//
// Every launcher returns cudaGetLastError() and launches on the stream it
// is given; it allocates nothing and does not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int32_t kTwin = 1 << 20;      // K7: twin flag rides the count

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
  const void* vals;       // null for K7
  const int32_t* toks;    // K6/K8 token plane (1 token, 2 product), or null
  int32_t* okeys;         // null for K7
  int32_t* okeys2;
  void* ovals;            // K7: the counts
  int C;
  int want_token;
};

// What rides the sort.  K5: key, value.  K6: + token.  K7: key only (the
// counts are derived after the sort).  K8: a 64-bit key packing (key,
// key2), value; K8T: + token.
enum Mode : int { M_K5 = 0, M_K6 = 1, M_K7 = 2, M_K8 = 3, M_K8T = 4 };

template <int MODE> struct ModeT {
  static constexpr bool kTok = MODE == M_K6 || MODE == M_K8T;
  static constexpr bool kWideKey = MODE == M_K8 || MODE == M_K8T;
  static constexpr bool kPair1 = MODE == M_K7;
  static constexpr bool kVals = !kPair1;
  // int32 planes of an exchange buffer: key (two halves when wide), value,
  // token
  static constexpr int kPlanes = (kWideKey ? 2 : 1) + (kVals ? 1 : 0) +
                                 (kTok ? 1 : 0);
  // C = 32768: one exchange buffer (own and inbox in one) where two do
  // not fit a block's 227 KB
  static constexpr bool kOneBuffer = kPlanes >= 4;
  using K = typename std::conditional<kWideKey, long long, int32_t>::type;
};

// K8's two keys as one signed 64-bit key in the same order: key in the
// high half, key2 with its sign bit flipped in the low half.
__device__ __forceinline__ long long pack_key(int32_t hi, int32_t lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<uint32_t>(hi)) << 32) |
      (static_cast<uint32_t>(lo) ^ 0x80000000u));
}
__device__ __forceinline__ int32_t key_hi(int32_t k) { return k; }
__device__ __forceinline__ int32_t key_hi(long long k) {
  return static_cast<int32_t>(k >> 32);
}
__device__ __forceinline__ int32_t key_lo(long long k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k) ^ 0x80000000u);
}
__device__ __forceinline__ int32_t kmin(int32_t a, int32_t b) {
  return min(a, b);
}
__device__ __forceinline__ int32_t kmax(int32_t a, int32_t b) {
  return max(a, b);
}
template <typename K> __device__ __forceinline__ K sentinel_key();
template <> __device__ __forceinline__ int32_t sentinel_key<int32_t>() {
  return kSentinel;
}
template <> __device__ __forceinline__ long long sentinel_key<long long>() {
  return pack_key(kSentinel, kSentinel);
}

constexpr int kP = 8;                          // slots a thread holds
constexpr int kChunks = kP / 4;                // 16-byte chunks a thread
constexpr int kSplit = 256;                    // A: j < kSplit, B: above
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQ = 8192;                       // slots of a 32-warp block
constexpr int kClusterBlocks = 4;
constexpr int kBigC = kClusterBlocks * kQ;     // 32768
constexpr int kCThreads = kQ / kP;
constexpr int kCWarps = kCThreads / 32;

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x >> 1);
}

// A block of NW warps: its slots, and layout B's lane stride (the slots
// of one warp in layout A).
template <int NW> struct Blk {
  static constexpr int kThreads = NW * 32;
  static constexpr int kSlots = kThreads * kP;
  static constexpr int kLaneB = NW * kP;
  static constexpr int kSwz = ilog2(kLaneB / 4);
  static_assert(kLaneB <= kSplit && kP % 4 == 0, "layouts A and B below");
};

// Two register layouts of a block's slots.  Thread (warp w, lane l) holds
// the kP consecutive slots from
//   A: (32 w + l) kP     slot bits below kP the register, the next 5 the
//                        lane, the rest the warp
//   B: l kLaneB + w kP   slot bits below kP the register, the 5 above
//                        kLaneB the lane, the bits between the warp
// so a stage with kP <= j < kSplit is a shuffle at lane distance j / kP
// in A, and one with kSplit <= j < kSlots a shuffle at lane distance
// j / kLaneB in B.
__device__ __forceinline__ int slot0_a() { return threadIdx.x * kP; }
template <int NW> __device__ __forceinline__ int slot0_b() {
  return (threadIdx.x & 31) * Blk<NW>::kLaneB + (threadIdx.x >> 5) * kP;
}

// The exchange buffers hold each plane as 16-byte chunks of 4 slots; chunk
// c sits at c ^ ((c >> kSwz) & 7) ^ ((c >> 3) & (kChunks - 1)), so that
// the 8 lanes of one 128-bit shared-memory phase hit 8 different bank
// groups in both layouts.  A thread's chunks c0 .. c0 + kChunks - 1 (c0 a
// multiple of kChunks) sit at chunk_at(c0) ^ h.
template <int NW> __device__ __forceinline__ int chunk_at(int c) {
  return c ^ ((c >> Blk<NW>::kSwz) & 7) ^ ((c >> 3) & (kChunks - 1));
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
template <int NW, typename T>
__device__ __forceinline__ void put_slots(int32_t* plane, int s0,
                                          const T (&x)[kP]) {
  int4* p = reinterpret_cast<int4*>(plane);
  const int c = chunk_at<NW>(s0 >> 2);
#pragma unroll
  for (int h = 0; h < kChunks; ++h) p[c ^ h] = pack4(x, h);
}

template <int NW, typename T>
__device__ __forceinline__ void get_slots(const int32_t* plane, int s0,
                                          T (&x)[kP]) {
  const int4* p = reinterpret_cast<const int4*>(plane);
  const int c = chunk_at<NW>(s0 >> 2);
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

// The output planes are 16-byte aligned (the launchers check).
template <typename T>
__device__ __forceinline__ void store_slots(T* dst, const T (&x)[kP]) {
#pragma unroll
  for (int h = 0; h < kChunks; ++h)
    __stcs(reinterpret_cast<int4*>(dst) + h, pack4(x, h));
}

// A thread's slots: keys, values (K7: its counts, from the keys after the
// sort) and tokens; after the sort the token registers hold the scan
// flags.
template <int MODE, typename V>
struct Tile {
  typename ModeT<MODE>::K k[kP];
  V v[kP];
  int32_t t[kP];
};

// The planes of an exchange buffer of S slots: key (K8: its high and low
// halves as packed), value, token.
template <int NW, int S, int MODE, typename V>
__device__ __forceinline__ void put_tile(int32_t* buf, int s0,
                                         const Tile<MODE, V>& r) {
  using M = ModeT<MODE>;
  if constexpr (M::kWideKey) {
    int32_t h[kP], l[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      h[i] = static_cast<int32_t>(r.k[i] >> 32);
      l[i] = static_cast<int32_t>(r.k[i]);
    }
    put_slots<NW>(buf, s0, h);
    put_slots<NW>(buf + S, s0, l);
  } else {
    put_slots<NW>(buf, s0, r.k);
  }
  constexpr int pv = M::kWideKey ? 2 : 1;
  if constexpr (M::kVals) put_slots<NW>(buf + pv * S, s0, r.v);
  if constexpr (M::kTok) put_slots<NW>(buf + (pv + 1) * S, s0, r.t);
}

template <int NW, int S, int MODE, typename V>
__device__ __forceinline__ void get_tile(const int32_t* buf, int s0,
                                         Tile<MODE, V>& r) {
  using M = ModeT<MODE>;
  if constexpr (M::kWideKey) {
    int32_t h[kP], l[kP];
    get_slots<NW>(buf, s0, h);
    get_slots<NW>(buf + S, s0, l);
#pragma unroll
    for (int i = 0; i < kP; ++i)
      r.k[i] = static_cast<long long>(
          (static_cast<unsigned long long>(static_cast<uint32_t>(h[i]))
           << 32) | static_cast<uint32_t>(l[i]));
  } else {
    get_slots<NW>(buf, s0, r.k);
  }
  constexpr int pv = M::kWideKey ? 2 : 1;
  if constexpr (M::kVals) get_slots<NW>(buf + pv * S, s0, r.v);
  if constexpr (M::kTok) get_slots<NW>(buf + (pv + 1) * S, s0, r.t);
}

// A thread's slots from device memory (SENTINEL keys where !live).
template <int MODE, typename V>
__device__ __forceinline__ void load_tile(const Planes& pl, int64_t base,
                                          bool live, Tile<MODE, V>& r) {
  using M = ModeT<MODE>;
  if (!live) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      r.k[i] = sentinel_key<typename M::K>();
      r.v[i] = V();
      r.t[i] = 0;
    }
    return;
  }
  if constexpr (M::kWideKey) {
    int32_t h[kP], l[kP];
    load_slots(pl.keys + base, h);
    load_slots(pl.keys2 + base, l);
#pragma unroll
    for (int i = 0; i < kP; ++i) r.k[i] = pack_key(h[i], l[i]);
  } else {
    load_slots(pl.keys + base, r.k);
  }
  if constexpr (M::kVals)
    load_slots(static_cast<const V*>(pl.vals) + base, r.v);
  if constexpr (M::kTok) load_slots(pl.toks + base, r.t);
}

// Keep the partner's slot i when it belongs here: the smaller key where
// keep_min, else the larger (equal keys stay, on both sides).  A min or
// max and selects, not branches: lanes disagree.  A 64-bit key has no
// min/max instruction: two strict compares decide, then selects.
template <int MODE, typename V>
__device__ __forceinline__ void keep(Tile<MODE, V>& r, int i, bool keep_min,
                                     typename ModeT<MODE>::K kb, V vb,
                                     int32_t tb) {
  const auto ka = r.k[i];
  bool take;
  if constexpr (ModeT<MODE>::kWideKey) {
    take = keep_min ? kb < ka : ka < kb;
    r.k[i] = take ? kb : ka;
  } else {
    const auto nk = keep_min ? kmin(ka, kb) : kmax(ka, kb);
    take = nk != ka;
    r.k[i] = nk;
  }
  if (ModeT<MODE>::kVals) r.v[i] = take ? vb : r.v[i];
  if (ModeT<MODE>::kTok) r.t[i] = take ? tb : r.t[i];
}

// The stage (k, j) with its partner d lanes away.  g0 (the thread's first
// slot in its run) is a multiple of kP <= j, so all the thread's slots
// share their direction ((g & k) == 0: ascending) and side ((g & j) == 0:
// lower); the lower slot of an ascending pair keeps the smaller key.
template <int MODE, typename V>
__device__ __forceinline__ void shfl_stage(Tile<MODE, V>& r, int g0, int k,
                                           int j, int d) {
  using M = ModeT<MODE>;
  const bool keep_min = ((g0 & k) == 0) == ((g0 & j) == 0);
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const auto kb = __shfl_xor_sync(kFull, r.k[i], d);
    const V vb = M::kVals ? __shfl_xor_sync(kFull, r.v[i], d) : V();
    const int32_t tb = M::kTok ? __shfl_xor_sync(kFull, r.t[i], d) : 0;
    keep(r, i, keep_min, kb, vb, tb);
  }
}

// The stages of merge k with j < kP, inside the thread; kOneDir: k >= kP,
// so the thread's slots share one direction.
template <bool kOneDir, int MODE, typename V>
__device__ __forceinline__ void thread_merge(Tile<MODE, V>& r, int g0,
                                             int k) {
  using M = ModeT<MODE>;
  const bool asc_all = (g0 & k) == 0;
#pragma unroll
  for (int j = kP / 2; j > 0; j >>= 1) {
    if (!kOneDir && j >= k) continue;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (i & j) continue;
      const int hi = i | j;
      const bool asc = kOneDir ? asc_all : ((g0 + i) & k) == 0;
      const auto a = r.k[i], b = r.k[hi];
      bool sw;
      if constexpr (M::kWideKey) {
        sw = asc ? b < a : a < b;
        r.k[i] = sw ? b : a;
        r.k[hi] = sw ? a : b;
      } else {
        r.k[i] = asc ? kmin(a, b) : kmax(a, b);
        r.k[hi] = asc ? kmax(a, b) : kmin(a, b);
        sw = r.k[i] != a;
      }
      if (M::kVals) {
        const V va = r.v[i], vb = r.v[hi];
        r.v[i] = sw ? vb : va;
        r.v[hi] = sw ? va : vb;
      }
      if (M::kTok) {
        const int32_t ta = r.t[i], tb = r.t[hi];
        r.t[i] = sw ? tb : ta;
        r.t[hi] = sw ? ta : tb;
      }
    }
  }
}

template <int MODE, typename V>
__device__ __forceinline__ void thread_stages(Tile<MODE, V>& r, int g0,
                                              int k) {
  if (k >= kP)
    thread_merge<true>(r, g0, k);
  else
    thread_merge<false>(r, g0, k);
}

// The merges k <= kmax inside one block of NW warps (ga / gb: the
// thread's first run slot in layouts A / B).  A thread writes and reads
// back only its own slots' places in one layout, so a barrier is needed
// only between a write in one layout and the read in the other.
template <int NW, int MODE, typename V>
__device__ __forceinline__ void block_merges(Tile<MODE, V>& r, int32_t* buf,
                                             int sa, int sb, int ga, int gb,
                                             int kmax) {
  constexpr int S = Blk<NW>::kSlots;
  constexpr int kLaneB = Blk<NW>::kLaneB;
  for (int k = 2; k <= kmax; k <<= 1) {
    if (k > kSplit) {
      put_tile<NW, S>(buf, sa, r);
      __syncthreads();
      get_tile<NW, S>(buf, sb, r);
      for (int j = k >> 1; j >= kSplit; j >>= 1)
        shfl_stage(r, gb, k, j, j / kLaneB);
      put_tile<NW, S>(buf, sb, r);
      __syncthreads();
      get_tile<NW, S>(buf, sa, r);
    }
    for (int j = min(k >> 1, kSplit >> 1); j >= kP; j >>= 1)
      shfl_stage(r, ga, k, j, j / kP);
    thread_stages(r, ga, k);
  }
}

// K7: the mask token of (rank, j) is unique and sorts just before its
// products: a group starting at key k has a twin where the slot before
// holds k - 1.
__device__ __forceinline__ bool twin_of(int32_t before, int32_t k) {
  return static_cast<uint32_t>(before) + 1u == static_cast<uint32_t>(k);
}

// The keys beside the thread's slots in its block of NW warps, after the
// sort: ``prev`` before its first slot and ``next`` after its last (the
// block's first and last threads get their own first and last key).  Each
// warp's first and last key go through s_first / s_last, which stay
// readable by the block (and its cluster) after the one __syncthreads.
template <int NW, int MODE, typename V>
__device__ __forceinline__ void block_edges(const Tile<MODE, V>& r,
                                            typename ModeT<MODE>::K* s_first,
                                            typename ModeT<MODE>::K* s_last,
                                            typename ModeT<MODE>::K& prev,
                                            typename ModeT<MODE>::K& next) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_first[w] = r.k[0];
  if (lane == 31) s_last[w] = r.k[kP - 1];
  __syncthreads();
  prev = __shfl_up_sync(kFull, r.k[kP - 1], 1);
  if (lane == 0) prev = w > 0 ? s_last[w - 1] : r.k[0];
  next = __shfl_down_sync(kFull, r.k[0], 1);
  if (lane == 31 && w + 1 < NW) next = s_first[w + 1];
}

// Group starts after the sort (flag bit 0; tokens move up one bit), and
// K7's values: 1 a product, plus kTwin at a group start with a twin.
// ``prev`` is the key before the thread's first slot, ``first_start``
// forces that slot to start a group, ``first_twin_ok`` allows it a twin.
template <int MODE, typename V>
__device__ __forceinline__ void start_flags(Tile<MODE, V>& r,
                                            typename ModeT<MODE>::K prev,
                                            bool first_start,
                                            bool first_twin_ok) {
  using M = ModeT<MODE>;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const auto pk = i > 0 ? r.k[i - 1] : prev;
    const bool start = (i == 0 && first_start) || r.k[i] != pk;
    r.t[i] = (M::kTok ? r.t[i] << 1 : 0) | (start ? 1 : 0);
    if constexpr (M::kPair1) {
      const int32_t k = r.k[i];
      const bool twin = start && (i > 0 || first_twin_ok) && twin_of(pk, k);
      const bool prod = (k & 1) != 0 && k != kSentinel;
      r.v[i] = (prod ? 1 : 0) + (twin ? kTwin : 0);
    }
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

// The scan totals a thread folds in: the lanes before it in its warp, the
// warps before it in its block, and the whole block's.
template <typename V> struct Prefix {
  V lane_v, warp_v, block_v;
  int32_t lane_f, warp_f, block_f;
};

// The inclusive segmented scan over the thread's own slots (in place),
// then its lanes' and its block's prefixes (one __syncthreads).
template <typename V, int OP, int NW, int MODE>
__device__ __forceinline__ Prefix<V> scan_block(Tile<MODE, V>& r, V* s_wv,
                                                int32_t* s_wf) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 1; i < kP; ++i) {
    if ((r.t[i] & 1) == 0) {
      r.v[i] = Mon<V, OP>::op(r.v[i - 1], r.v[i]);
      r.t[i] |= r.t[i - 1];
    }
  }
  Prefix<V> p;
  V tv = r.v[kP - 1];
  int32_t tf = r.t[kP - 1];
  warp_scan<V, OP>(tv, tf, lane);
  p.lane_v = __shfl_up_sync(kFull, tv, 1);
  p.lane_f = __shfl_up_sync(kFull, tf, 1);
  if (lane == 31) {
    s_wv[w] = tv;
    s_wf[w] = tf;
  }
  __syncthreads();
  // every warp scans the warp totals: its prefix is lane w - 1's
  V wv = lane < NW ? s_wv[lane] : V();
  int32_t wf = lane < NW ? s_wf[lane] : 0;
  warp_scan<V, OP>(wv, wf, lane);
  p.warp_v = __shfl_sync(kFull, wv, (w + 31) & 31);
  p.warp_f = __shfl_sync(kFull, wf, (w + 31) & 31);
  p.block_v = __shfl_sync(kFull, wv, NW - 1);
  p.block_f = __shfl_sync(kFull, wf, NW - 1);
  return p;
}

// Fold (v, f), the totals of the slots that follow the carry so far, into
// the carry (cv, cf): a group start in them replaces it.
template <typename V, int OP>
__device__ __forceinline__ void fold(bool h, V v, int32_t f, bool& have,
                                     V& cv, int32_t& cf) {
  if (!h) return;
  if (!have || (f & 1)) {
    cv = v;
    cf = f;
  } else {
    cv = Mon<V, OP>::op(cv, v);
    cf |= f;
  }
  have = true;
}

// Apply the thread's exclusive prefix (have, cv, cf), find group ends
// (``next`` is the key after the thread's last slot, ``last_end`` forces
// that slot to end a group), keep, and store at ``base`` where ``live``.
template <typename V, int OP, int MODE>
__device__ __forceinline__ void finish(Tile<MODE, V>& r, bool have, V cv,
                                       int32_t cf,
                                       typename ModeT<MODE>::K next,
                                       bool last_end, const Planes& pl,
                                       int64_t base, bool live) {
  using M = ModeT<MODE>;
  int32_t ok[kP], ok2[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    if (have && (r.t[i] & 1) == 0) {
      r.v[i] = Mon<V, OP>::op(cv, r.v[i]);
      r.t[i] |= cf;
    }
    const bool end = i + 1 < kP ? r.k[i] != r.k[i + 1]
                                : (last_end || r.k[i] != next);
    const int32_t kh = key_hi(r.k[i]);
    bool keep_it = end && kh != kSentinel;
    if constexpr (M::kPair1) {
      const int32_t cnt = r.v[i] & (kTwin - 1);
      const int has_twin = (r.v[i] & kTwin) != 0 ? 1 : 0;
      keep_it = keep_it && (kh & 1) != 0 && cnt > 0 &&
                has_twin == pl.want_token;
      ok[i] = keep_it ? cnt : 0;
    } else {
      if (M::kTok) {
        const int32_t t = r.t[i] >> 1;
        keep_it = keep_it && (t & 2) != 0 && (t & 1) == pl.want_token;
      }
      ok[i] = keep_it ? kh : kSentinel;
      if constexpr (M::kWideKey) ok2[i] = keep_it ? key_lo(r.k[i])
                                                  : kSentinel;
    }
  }
  if (!live) return;
  if constexpr (M::kPair1) {
    store_slots(static_cast<int32_t*>(pl.ovals) + base, ok);
  } else {
    store_slots(pl.okeys + base, ok);
    if constexpr (M::kWideKey) store_slots(pl.okeys2 + base, ok2);
    store_slots(static_cast<V*>(pl.ovals) + base, r.v);
  }
}

// ---------------------------------------------------------------------------
// C <= 8192: NW * 256 / C runs a block of NW warps, sorted and scanned in
// registers
// ---------------------------------------------------------------------------

template <typename V, int OP, int MODE, int NW>
__global__ void __launch_bounds__(NW * 32, 32 / NW)
sort_reduce_block_regs_kernel(Planes pl, int64_t nslots) {
  using K = typename ModeT<MODE>::K;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ K s_first[NW];              // first key of each warp's slots
  __shared__ K s_last[NW];               // last key of each warp's slots
  __shared__ V s_wv[NW];                 // each warp's scan total
  __shared__ int32_t s_wf[NW];
  const int C = pl.C;
  const int sa = slot0_a();
  const int sb = slot0_b<NW>();
  const int64_t base = int64_t(blockIdx.x) * Blk<NW>::kSlots + sa;
  const bool live = base < nslots;       // a thread's slots share a run
  Tile<MODE, V> r;
  load_tile(pl, base, live, r);
  block_merges<NW>(r, reinterpret_cast<int32_t*>(smem), sa, sb,
                   sa & (C - 1), sb & (C - 1), C);

  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  K prev, next;
  block_edges<NW>(r, s_first, s_last, prev, next);
  const bool run_first = (sa & (C - 1)) == 0;
  start_flags(r, prev, run_first, !run_first);
  const Prefix<V> p = scan_block<V, OP, NW>(r, s_wv, s_wf);
  bool have = false;
  V cv = V();
  int32_t cf = 0;
  fold<V, OP>(w > 0, p.warp_v, p.warp_f, have, cv, cf);
  fold<V, OP>(lane > 0, p.lane_v, p.lane_f, have, cv, cf);
  finish<V, OP>(r, have, cv, cf, next, ((sa + kP) & (C - 1)) == 0, pl, base,
                live);
}

// ---------------------------------------------------------------------------
// C = 32768: one run per cluster of kClusterBlocks blocks of kQ slots,
// sorted and scanned in registers
// ---------------------------------------------------------------------------

// A stage with j >= kQ: the partner of run slot g is the same local slot
// in block rank ^ (j / kQ), which has written its slots into this block's
// inbox; this thread reads its own slots' places there, a chunk at a time.
template <int MODE, typename V>
__device__ __forceinline__ void cluster_stage(Tile<MODE, V>& r,
                                              const int32_t* inbox, int g0,
                                              int s0, int k, int j) {
  using M = ModeT<MODE>;
  const bool keep_min = ((g0 & k) == 0) == ((g0 & j) == 0);
  const int c = chunk_at<kCWarps>(s0 >> 2);
  constexpr int pv = M::kWideKey ? 2 : 1;
  const int4* pk = reinterpret_cast<const int4*>(inbox);
  const int4* pk2 = reinterpret_cast<const int4*>(inbox + kQ);
  const int4* pvv = reinterpret_cast<const int4*>(inbox + pv * kQ);
  const int4* pt = reinterpret_cast<const int4*>(inbox + (pv + 1) * kQ);
  const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    const int4 a = pk[c ^ h];
    const int4 a2 = M::kWideKey ? pk2[c ^ h] : z;
    const int4 b = M::kVals ? pvv[c ^ h] : z;
    const int4 t = M::kTok ? pt[c ^ h] : z;
    const int32_t ka[4] = {a.x, a.y, a.z, a.w};
    const int32_t ka2[4] = {a2.x, a2.y, a2.z, a2.w};
    const int32_t vb[4] = {b.x, b.y, b.z, b.w};
    const int32_t tb[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      typename M::K kb;
      if constexpr (M::kWideKey)
        kb = static_cast<long long>(
            (static_cast<unsigned long long>(static_cast<uint32_t>(ka[e]))
             << 32) | static_cast<uint32_t>(ka2[e]));
      else
        kb = ka[e];
      keep(r, 4 * h + e, keep_min, kb, from_bits<V>(vb[e]), tb[e]);
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

template <int MODE> constexpr size_t cluster_smem() {
  return size_t(kQ) * sizeof(int32_t) * ModeT<MODE>::kPlanes *
         (ModeT<MODE>::kOneBuffer ? 1 : 2);
}

// K5 / K6 / K7 / K8 at C = kBigC: blocks 4r..4r+3 (one cluster) hold run r.
template <typename V, int OP, int MODE>
__global__ void __launch_bounds__(kCThreads, 1)
sort_reduce_cluster_regs_kernel(Planes pl) {
  using M = ModeT<MODE>;
  using K = typename M::K;
  constexpr bool kOne = M::kOneBuffer;
  constexpr int kLaneB = Blk<kCWarps>::kLaneB;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ K s_first[kCWarps];         // first key of each warp's slots
  __shared__ K s_last[kCWarps];          // last key of each warp's slots
  __shared__ V s_wv[kCWarps];            // each warp's scan total
  __shared__ int32_t s_wf[kCWarps];
  __shared__ V s_bv;                     // the block's scan total, its
  __shared__ int32_t s_bf;               // first slot taken as no start
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // two exchange buffers: this block's own (transpositions) and its inbox
  // (the stages across the cluster); one that is both where kOne
  int32_t* own = reinterpret_cast<int32_t*>(smem);
  int32_t* inbox = kOne ? own : own + M::kPlanes * kQ;
  const int gbase = static_cast<int>(rank) * kQ;
  const int sa = slot0_a();
  const int sb = slot0_b<kCWarps>();
  const int ga = gbase + sa;
  const int gb = gbase + sb;
  const int64_t base =
      int64_t(blockIdx.x / kClusterBlocks) * kBigC + gbase + sa;
  if (!kOne) cluster_arrive();   // a peer writes here only once all started
  Tile<MODE, V> r;
  load_tile(pl, base, true, r);
  block_merges<kCWarps>(r, own, sa, sb, ga, gb, kQ);
  // Merges across the cluster.  For each stage with j >= kQ a block writes
  // its slots into the partner's inbox (once the partner is done reading
  // it), and after a cluster barrier compares with what its own inbox
  // holds, in layout B; the first such stage of a merge also moves the
  // block's own slots from layout A to B (with one buffer, that move comes
  // first, and a full cluster barrier then frees every buffer).  Then
  // layout B's stages, then A's.
  for (int k = 2 * kQ; k <= kBigC; k <<= 1) {
    put_tile<kCWarps, kQ>(own, sa, r);
    if (kOne) {
      __syncthreads();
      get_tile<kCWarps, kQ>(own, sb, r);
    }
    for (int j = k >> 1; j >= kQ; j >>= 1) {
      const unsigned prank = rank ^ static_cast<unsigned>(j / kQ);
      const bool move = !kOne && j == k >> 1;
      if (kOne)
        cluster.sync();
      else
        cluster_wait();
      put_tile<kCWarps, kQ>(cluster.map_shared_rank(inbox, prank),
                            move ? sa : sb, r);
      cluster.sync();
      if (move) get_tile<kCWarps, kQ>(own, sb, r);
      cluster_stage(r, inbox, gb, sb, k, j);
      if (!kOne) cluster_arrive();
    }
    for (int j = kQ >> 1; j >= kSplit; j >>= 1)
      shfl_stage(r, gb, k, j, j / kLaneB);
    put_tile<kCWarps, kQ>(own, sb, r);
    __syncthreads();
    get_tile<kCWarps, kQ>(own, sa, r);
    for (int j = kSplit >> 1; j >= kP; j >>= 1)
      shfl_stage(r, ga, k, j, j / kP);
    thread_stages(r, ga, k);
  }

  // Group starts.  The block's first slot is taken as no start here and
  // settled against the block before once the cluster has published its
  // edges.
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  K prev, next;
  block_edges<kCWarps>(r, s_first, s_last, prev, next);
  start_flags(r, prev, false, true);
  const Prefix<V> p = scan_block<V, OP, kCWarps>(r, s_wv, s_wf);
  if (threadIdx.x == 0) {
    s_bv = p.block_v;
    s_bf = p.block_f;
  }
  if (!kOne) cluster_wait();
  cluster.sync();                        // edges and totals published

  // The carry: if this block's first slot continues the block before's
  // last group, the fold of the earlier blocks' totals, nearest first, up
  // to and including the first that holds a group start (K7: with the
  // twin of a group that starts at that block's first slot).  If it starts
  // a group that has a twin (K7), the twin alone.
  bool have = false;
  V cv = V();
  int32_t cf = 0;
  const auto last_of = [&](int q) {
    return *cluster.map_shared_rank(&s_last[kCWarps - 1], q);
  };
  const auto first_of = [&](int q) {
    return *cluster.map_shared_rank(&s_first[0], q);
  };
  if (rank > 0) {
    const K before = last_of(rank - 1);
    if (s_first[0] == before) {
      for (int q = static_cast<int>(rank) - 1; q >= 0; --q) {
        V qv = *cluster.map_shared_rank(&s_bv, q);
        const int32_t bf = *cluster.map_shared_rank(&s_bf, q);
        int32_t qf = bf;
        if (q == 0) {
          qf |= 1;                       // the run's first slot starts
        } else {
          const K lq = last_of(q - 1), fq = first_of(q);
          if (fq != lq) {
            qf |= 1;                     // block q's first slot starts
            if constexpr (M::kPair1)
              if ((bf & 1) == 0 && twin_of(lq, fq))
                qv = Mon<V, OP>::op(qv, V(kTwin));
          }
        }
        cv = have ? Mon<V, OP>::op(qv, cv) : qv;
        cf |= qf;
        have = true;
        if (qf & 1) break;
      }
    } else if constexpr (M::kPair1) {
      if (twin_of(before, s_first[0])) {
        have = true;
        cv = V(kTwin);
        cf = 1;
      }
    }
  }
  const bool run_end = rank + 1 == kClusterBlocks &&
                       threadIdx.x == kCThreads - 1;
  if (threadIdx.x == kCThreads - 1 && !run_end) next = first_of(rank + 1);
  cluster_arrive();                      // no more reads of the peers

  // the thread's exclusive prefix: the carry, the warps before, the lanes
  // before, in that order
  fold<V, OP>(w > 0, p.warp_v, p.warp_f, have, cv, cf);
  fold<V, OP>(lane > 0, p.lane_v, p.lane_f, have, cv, cf);
  finish<V, OP>(r, have, cv, cf, next, run_end, pl, base, true);
  cluster_wait();
}

// The block kernel's warps a block: kRunWarps for C <= kRunWarpsMaxC, else
// 32 (C = 8192 fills a 32-warp block).  Four 8-warp blocks an SM beat two
// of 16 and one of 32 (the SM holds 32 warps at 64 registers in each
// case; with more blocks, one block's loads, barriers and stores overlap
// the others' stages).
constexpr int kRunWarps = 8;
constexpr int kRunWarpsMaxC = Blk<kRunWarps>::kSlots;

template <int MODE, int NW> constexpr size_t block_smem() {
  return size_t(Blk<NW>::kSlots) * sizeof(int32_t) * ModeT<MODE>::kPlanes;
}

bool outputs_aligned(const Planes& pl) {
  return ((reinterpret_cast<uintptr_t>(pl.okeys) |
           reinterpret_cast<uintptr_t>(pl.okeys2) |
           reinterpret_cast<uintptr_t>(pl.ovals)) & 15) == 0;
}

template <typename V, int OP, int MODE, int NW>
cudaError_t launch_block_t(const Planes& pl, int64_t nruns, cudaStream_t s) {
  const auto kernel = sort_reduce_block_regs_kernel<V, OP, MODE, NW>;
  // no exchange buffer where every stage is a shuffle; with one, the
  // limit is raised (the static 48 KB window also holds the scan totals)
  const size_t smem = pl.C > kSplit ? block_smem<MODE, NW>() : 0;
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t nslots = nruns * pl.C;
  const int64_t blocks = (nslots + Blk<NW>::kSlots - 1) / Blk<NW>::kSlots;
  kernel<<<static_cast<unsigned>(blocks), Blk<NW>::kThreads, smem, s>>>(
      pl, nslots);
  return cudaSuccess;
}

// C = kBigC: clusters of kClusterBlocks blocks (cudaLaunchKernelEx with
// the cluster-dimension attribute); the exchange buffers are the dynamic
// shared memory.  The kernel's shared-memory limit set, and its launch
// configuration for nruns runs (cfg.attrs points into attr).
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

template <typename V, int OP, int MODE>
cudaError_t launch_cluster_t(const Planes& pl, int64_t nruns,
                             cudaStream_t s) {
  const auto kernel = sort_reduce_cluster_regs_kernel<V, OP, MODE>;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const cudaError_t e =
      cluster_config(kernel, cluster_smem<MODE>(), nruns, s, attr, &cfg);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kernel, pl);
}

// C one of the sort classes (CAPS in kernels/sortreduce.py)
bool class_ok(int64_t C) {
  return C == 128 || C == 512 || C == 2048 || C == kQ || C == kBigC;
}

template <typename V, int OP, int MODE>
cudaError_t launch_mode(const Planes& pl, int64_t nruns, cudaStream_t s) {
  if (!outputs_aligned(pl)) return cudaErrorInvalidValue;  // 16-B stores
  if (pl.C == kBigC) return launch_cluster_t<V, OP, MODE>(pl, nruns, s);
  if (pl.C <= kRunWarpsMaxC)
    return launch_block_t<V, OP, MODE, kRunWarps>(pl, nruns, s);
  return launch_block_t<V, OP, MODE, 32>(pl, nruns, s);
}

template <typename V, int OP>
cudaError_t launch_sr(const Planes& pl, int64_t nruns, cudaStream_t s) {
  if (pl.keys2 != nullptr)
    return pl.toks != nullptr ? launch_mode<V, OP, M_K8T>(pl, nruns, s)
                              : launch_mode<V, OP, M_K8>(pl, nruns, s);
  return pl.toks != nullptr ? launch_mode<V, OP, M_K6>(pl, nruns, s)
                            : launch_mode<V, OP, M_K5>(pl, nruns, s);
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
  if (!class_ok(C) || (keys2 != nullptr) != (okeys2 != nullptr))
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
  if (!class_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl{static_cast<const int32_t*>(keys), nullptr, nullptr,
                  nullptr, nullptr, nullptr, out, static_cast<int>(C),
                  static_cast<int>(want_token)};
  const cudaError_t e = launch_mode<int32_t, OP_PLUS, M_K7>(
      pl, nruns, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename K>
cudaError_t attributes(K kernel, int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  out[1] = fa.numRegs;
  out[2] = static_cast<int32_t>(fa.localSizeBytes);
  out[3] = static_cast<int32_t>(fa.sharedSizeBytes);
  return cudaSuccess;
}

template <typename V, int MODE>
cudaError_t info_t(int64_t C, int32_t* out) {
  if (C == kBigC) {
    const auto kernel = sort_reduce_cluster_regs_kernel<V, OP_PLUS, MODE>;
    const size_t smem = cluster_smem<MODE>();
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    cudaError_t e = cluster_config(kernel, smem, 1, nullptr, attr, &cfg);
    if (e == cudaSuccess) e = attributes(kernel, out);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&out[0], kernel, &cfg);
    out[4] = static_cast<int32_t>(smem);
    return e;
  }
  const auto launch_info = [&](auto kernel, int threads, size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess) e = attributes(kernel, out);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                        threads, smem);
    out[4] = static_cast<int32_t>(smem);
    return e;
  };
  if (C <= kRunWarpsMaxC)
    return launch_info(sort_reduce_block_regs_kernel<V, OP_PLUS, MODE,
                                                     kRunWarps>,
                       Blk<kRunWarps>::kThreads,
                       C > kSplit ? block_smem<MODE, kRunWarps>() : 0);
  return launch_info(sort_reduce_block_regs_kernel<V, OP_PLUS, MODE, 32>,
                     Blk<32>::kThreads,
                     C > kSplit ? block_smem<MODE, 32>() : 0);
}

}  // namespace

// The kernel that runs mode (0 K5, 1 K6, 2 K7, 3 K8, 4 K8 with tokens;
// PLUS, fp32 values but K7's int32 counts) at class C, on the current
// card: out[0] the most blocks an SM holds at once (C <= 8192) or the most
// clusters the card holds (C = 32768), out[1] registers a thread, out[2]
// local memory a thread (spills), out[3] static and out[4] dynamic shared
// memory a block, in bytes.
extern "C" int gb_sort_reduce_info(int64_t mode, int64_t C, int32_t* out) {
  if (!class_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  switch (mode) {
    case M_K5: e = info_t<float, M_K5>(C, out); break;
    case M_K6: e = info_t<float, M_K6>(C, out); break;
    case M_K7: e = info_t<int32_t, M_K7>(C, out); break;
    case M_K8: e = info_t<float, M_K8>(C, out); break;
    case M_K8T: e = info_t<float, M_K8T>(C, out); break;
    default: break;
  }
  return static_cast<int>(e);
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hand-written Hopper (sm_90a) gather-permute kernel for graphblas_tpu_torch
// (kernels/static_route.py), K9: out_k[p] = x_k[perm[p]] for one or two
// payloads x_0, x_1 through the same permutation, read once.  perm is int32
// or int64 (torch.sort's order needs no conversion pass); a payload element
// is a row of w bytes: 1, 2, 4, 8 or 16 (FC64) bytes, or a struct row of
// any width, moved in the widest unit of 16, 8, 4, 2 or 1 bytes that
// divides w and the addresses of x_k and out_k.
//
// Replaces the static permutation executors of graphblas_tpu/kernels/
// static_route.py: sublane_permute (per-lane Benes networks on an (R, 128)
// tile), tile_permute (lane gather, sublane Benes, lane gather) and
// global_permute (two Clos-routed passes over (2048, 128) tiles).  Those
// route a permutation through fixed networks because the TPU's TensorCore
// cannot gather; Hopper gathers from device memory directly, so the port
// takes the permutation itself.  The port's CSR <-> CSC reorient
// (core/convert.py) sends the row ids and the values of a matrix through
// one call, in the order of a stable sort.
//
// What bounds it on an H100: each output reads its perm entry and writes
// its element, streaming, and reads one element of x at a place the
// permutation chooses.  The compulsory traffic is (perm bytes + 2 w) an
// element at 3.35 TB/s (12 B for fp32 and an int32 perm), but a random
// read that misses the 50 MB L2 fetches a whole 32-byte sector from device
// memory for w bytes, and random sectors arrive at well under half the
// streaming rate.  A reorient's x is as large as the matrix's values (67 MB
// of fp32 at 2^24 nonzeros), larger than L2, so most reads miss: the
// random reads, one sector an output and payload, bound the kernel.  The
// design (graphblas_tpu_torch/tools/probe_permute.py measured each part):
//
//   * outputs in flight: each thread takes E = 4 outputs a tile-width
//     apart, loads their perm entries, then their elements, then stores
//     them: independent random reads in flight, every perm load and out
//     store of a warp coalesced (8 a thread measured the same, 16 slower);
//   * L2-blocked passes (2 or 3 where the gathered rows fill 2-3 times
//     kPassBytes, else one; passes_for below): pass s gathers only the
//     outputs whose source lies in the s-th equal range of x, so that
//     range stays in L2 while the pass reads it at random; x's reads keep
//     their lines with an evict_last policy and perm's stream past them
//     with evict_first, and the launcher puts x's lines back to
//     evict_normal after the last pass.  Each pass reads perm again and
//     stores part of every output sector, which costs as much as a whole
//     store pass: past three passes that costs more than the misses it
//     saves;
//   * two payloads as packed rows: when the first payload is 4 bytes (the
//     reorient's row ids) and the second 1, 2, 4 or 8, a streaming pass
//     packs both into one row of 8 or 16 bytes (``pairs``), and the gather
//     reads one sector an output instead of two and stores the two halves
//     to their outputs.
//
// A plan's two-phase route (the Hopper form of the JAX global_permute's two
// Clos passes, every access streaming) measured 0.183 ms at 2^24 fp32
// elements against 0.268 for the passes, but a fresh permutation cannot pay
// for a plan (two sorts and a scatter) and no caller reuses one, so it is
// not kept.
//
// The launcher returns cudaGetLastError(), launches on the stream it is
// given, allocates nothing and does not synchronise.  The caller checks
// that every perm entry lies in [0, nx).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // outputs a thread (E)
// bytes of gathered rows a pass keeps in L2, and at most kMaxPasses such
// passes (more sources than that take one pass)
constexpr int64_t kPassBytes = int64_t(24) << 20;
constexpr int64_t kMaxPasses = 3;

__device__ __forceinline__ uint64_t policy_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_normal() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// loads through the read-only path, no L1 allocation, an L2 policy
__device__ __forceinline__ int32_t ld(const int32_t* a, uint64_t pol) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(a), "l"(pol));
  return v;
}
__device__ __forceinline__ int64_t ld(const int64_t* a, uint64_t pol) {
  int64_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s64 %0, [%1], %2;"
      : "=l"(v) : "l"(a), "l"(pol));
  return v;
}
__device__ __forceinline__ uint8_t ld(const uint8_t* a, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v) : "l"(a), "l"(pol));
  return static_cast<uint8_t>(v);
}
__device__ __forceinline__ uint16_t ld(const uint16_t* a, uint64_t pol) {
  uint16_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(v) : "l"(a), "l"(pol));
  return v;
}
__device__ __forceinline__ uint32_t ld(const uint32_t* a, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v) : "l"(a), "l"(pol));
  return v;
}
__device__ __forceinline__ uint64_t ld(const uint64_t* a, uint64_t pol) {
  uint64_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u64 %0, [%1], %2;"
      : "=l"(v) : "l"(a), "l"(pol));
  return v;
}
__device__ __forceinline__ uint2 ld(const uint2* a, uint64_t pol) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.u32 {%0, %1}, [%2], "
      "%3;"
      : "=r"(v.x), "=r"(v.y) : "l"(a), "l"(pol));
  return v;
}
__device__ __forceinline__ uint4 ld(const uint4* a, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(a), "l"(pol));
  return v;
}

// one payload: x and out as arrays of units U, k units an element
struct Payload {
  const void* x;
  void* out;
  int64_t k;
  int unit;  // log2 of the unit's bytes
};

// the perm entries of a thread's E outputs, -1 where the output lies past n
// or its source outside [lo, hi)
template <typename P, int E>
__device__ __forceinline__ void sources(const P* __restrict__ perm,
                                        int64_t n, int64_t base, int64_t lo,
                                        int64_t hi, P (&src)[E]) {
  const uint64_t pp = policy_first();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int64_t p = base + int64_t(e) * kThreads;
    P i = -1;
    if (p < n) {
      i = ld(perm + p, pp);
      if (i < lo || i >= hi) i = -1;
    }
    src[e] = i;
  }
}

// The E elements of one thread: E loads in flight, then E stores (one unit
// an element), or a row of k units at a time for wider rows.
template <typename U, typename P, int E>
__device__ __forceinline__ void gather_tile(const Payload& pl,
                                            const P (&src)[E], int64_t base,
                                            uint64_t px) {
  const U* x = static_cast<const U*>(pl.x);
  U* out = static_cast<U*>(pl.out);
  if (pl.k == 1) {
    U v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = src[e] < 0 ? U{} : ld(x + src[e], px);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (src[e] >= 0) out[base + int64_t(e) * kThreads] = v[e];
    return;
  }
  for (int e = 0; e < E; ++e) {
    if (src[e] < 0) continue;
    const U* s = x + int64_t(src[e]) * pl.k;
    U* d = out + (base + int64_t(e) * kThreads) * pl.k;
    for (int64_t j = 0; j < pl.k; ++j) d[j] = ld(s + j, px);
  }
}

template <typename P, int E>
__device__ __forceinline__ void gather_payload(const Payload& pl,
                                               const P (&src)[E],
                                               int64_t base, uint64_t px) {
  switch (pl.unit) {
    case 0: gather_tile<uint8_t>(pl, src, base, px); break;
    case 1: gather_tile<uint16_t>(pl, src, base, px); break;
    case 2: gather_tile<uint32_t>(pl, src, base, px); break;
    case 3: gather_tile<uint64_t>(pl, src, base, px); break;
    default: gather_tile<uint4>(pl, src, base, px); break;
  }
}

// One pass over all n outputs: a block takes kThreads * E consecutive
// outputs, thread t the outputs base + e * kThreads (e < E); outputs whose
// source lies outside [lo, hi) are left for another pass.  ``keep``: one of
// several passes, so x's lines are read evict_last.
template <typename P, int E>
__global__ void __launch_bounds__(kThreads)
permute_gather_kernel(const P* __restrict__ perm, int64_t n, Payload a,
                      Payload b, int two, int64_t lo, int64_t hi, int keep) {
  const uint64_t px = keep ? policy_last() : policy_normal();
  const int64_t base = int64_t(blockIdx.x) * (kThreads * E) + threadIdx.x;
  P src[E];
  sources(perm, n, base, lo, hi, src);
  gather_payload(a, src, base, px);
  if (two) gather_payload(b, src, base, px);
}

// -- two payloads as packed rows: 4-byte ids and a value of 1 to 8 bytes ---

template <typename V>
struct alignas(sizeof(V) > 4 ? 16 : 8) Pair {
  uint32_t id;
  V val;
};
template <typename V>
using PairWord =
    typename std::conditional<sizeof(Pair<V>) == 16, uint4, uint2>::type;

template <typename V>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ ids, const V* __restrict__ vals,
            Pair<V>* __restrict__ pairs, int64_t nx) {
  const int64_t q = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (q < nx) {
    Pair<V> r{};
    r.id = ids[q];
    r.val = vals[q];
    PairWord<V> w;  // one 8- or 16-byte store
    memcpy(&w, &r, sizeof(r));
    reinterpret_cast<PairWord<V>*>(pairs)[q] = w;
  }
}

template <typename P, typename V, int E>
__global__ void __launch_bounds__(kThreads)
gather_pairs_kernel(const P* __restrict__ perm, int64_t n,
                    const Pair<V>* __restrict__ pairs,
                    uint32_t* __restrict__ out_ids, V* __restrict__ out_vals,
                    int64_t lo, int64_t hi, int keep) {
  using W = PairWord<V>;
  const uint64_t px = keep ? policy_last() : policy_normal();
  const int64_t base = int64_t(blockIdx.x) * (kThreads * E) + threadIdx.x;
  P src[E];
  sources(perm, n, base, lo, hi, src);
  W w[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    w[e] = src[e] < 0 ? W{}
                      : ld(reinterpret_cast<const W*>(pairs + src[e]), px);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (src[e] < 0) continue;
    Pair<V> r;
    memcpy(&r, &w[e], sizeof(r));
    out_ids[base + int64_t(e) * kThreads] = r.id;
    out_vals[base + int64_t(e) * kThreads] = r.val;
  }
}

// -- launchers ---------------------------------------------------------------

// x's lines back to evict_normal after the passes that kept them evict_last
__global__ void __launch_bounds__(kThreads)
demote_lines(const char* __restrict__ x, int64_t lines) {
  const int64_t l = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (l < lines)
    asm volatile("applypriority.global.L2::evict_normal [%0], 128;"
                 :: "l"(x + l * 128) : "memory");
}

cudaError_t demote(const void* x, int64_t bytes, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) & ~uintptr_t(127);
  const int64_t lines =
      (reinterpret_cast<uintptr_t>(x) + bytes - a + 127) / 128;
  if (lines <= 0) return cudaSuccess;
  demote_lines<<<static_cast<unsigned>((lines + kThreads - 1) / kThreads),
                 kThreads, 0, stream>>>(reinterpret_cast<const char*>(a),
                                        lines);
  return cudaGetLastError();
}

Payload payload(const void* x, void* out, int64_t w) {
  int unit = 4;  // the widest unit dividing w and both addresses
  while (unit > 0) {
    const int64_t u = int64_t(1) << unit;
    if (w % u == 0 && reinterpret_cast<uintptr_t>(x) % u == 0 &&
        reinterpret_cast<uintptr_t>(out) % u == 0)
      break;
    --unit;
  }
  return Payload{x, out, w >> unit, unit};
}

// L2-blocked passes for nx gathered rows of ``row`` bytes: 2 or 3 where
// the rows fill that many times kPassBytes, else one
int64_t passes_for(int64_t nx, int64_t row) {
  const int64_t passes = (nx * row + kPassBytes - 1) / kPassBytes;
  return passes > 1 && passes <= kMaxPasses ? passes : 1;
}

// the grid of a pass over n outputs, ``per_thread`` a thread (0 when too
// large)
unsigned grid(int64_t n, int per_thread = kPerThread) {
  const int64_t tile = int64_t(kThreads) * per_thread;
  const int64_t blocks = (n + tile - 1) / tile;
  return blocks > 0x7fffffff ? 0u : static_cast<unsigned>(blocks);
}

// one launch(lo, hi, keep) for each [lo, hi) of ``passes`` equal ranges of
// [0, nx), or one unbounded when passes == 1
template <typename F>
cudaError_t by_pass(int64_t nx, int64_t passes, F&& launch) {
  const int64_t seg = (nx + passes - 1) / passes;
  for (int64_t lo = 0; lo < nx; lo += seg) {
    launch(passes == 1 ? INT64_MIN : lo, passes == 1 ? INT64_MAX : lo + seg,
           passes > 1 ? 1 : 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename P>
cudaError_t launch_rows(const void* perm, int64_t n, Payload a, Payload b,
                        int two, int64_t nx, int64_t passes,
                        cudaStream_t s) {
  const unsigned g = grid(n);
  if (!g) return cudaErrorInvalidValue;
  return by_pass(nx, passes, [&](int64_t lo, int64_t hi, int keep) {
    permute_gather_kernel<P, kPerThread><<<g, kThreads, 0, s>>>(
        static_cast<const P*>(perm), n, a, b, two, lo, hi, keep);
  });
}

template <typename P, typename V>
cudaError_t launch_pairs(const void* perm, int64_t n, Payload a, Payload b,
                         int64_t nx, int64_t passes, void* pairs,
                         cudaStream_t s) {
  auto* pr = static_cast<Pair<V>*>(pairs);
  const unsigned g = grid(n), gx = grid(nx, 1);
  if (!g || !gx) return cudaErrorInvalidValue;
  pack_kernel<V><<<gx, kThreads, 0, s>>>(static_cast<const uint32_t*>(a.x),
                                        static_cast<const V*>(b.x), pr, nx);
  return by_pass(nx, passes, [&](int64_t lo, int64_t hi, int keep) {
    gather_pairs_kernel<P, V, kPerThread><<<g, kThreads, 0, s>>>(
        static_cast<const P*>(perm), n, pr, static_cast<uint32_t*>(a.out),
        static_cast<V*>(b.out), lo, hi, keep);
  });
}

template <typename P>
cudaError_t launch_pairs_by_width(const void* perm, int64_t n, Payload a,
                                  Payload b, int64_t nx, int64_t passes,
                                  void* pairs, cudaStream_t s) {
  switch (b.unit) {
    case 0:
      return launch_pairs<P, uint8_t>(perm, n, a, b, nx, passes, pairs, s);
    case 1:
      return launch_pairs<P, uint16_t>(perm, n, a, b, nx, passes, pairs, s);
    case 2:
      return launch_pairs<P, uint32_t>(perm, n, a, b, nx, passes, pairs, s);
    default:
      return launch_pairs<P, uint64_t>(perm, n, a, b, nx, passes, pairs, s);
  }
}

}  // namespace

// Bytes of the packed row of two payloads of w0 and w1 bytes (0: they are
// gathered apart): the ``pairs`` scratch holds nx such rows.
extern "C" int64_t gb_permute_pair_bytes(int64_t w0, int64_t w1) {
  if (w0 != 4) return 0;
  switch (w1) {
    case 1: case 2: case 4: return 8;
    case 8: return 16;
    default: return 0;
  }
}

// out0[p] = x0[perm[p]] (rows of w0 bytes) for p < n and, when w1 > 0,
// out1[p] = x1[perm[p]] (rows of w1 bytes) in the same call.  perm holds
// perm_bytes = 4 or 8 byte signed indices into the nx rows of x0 (and x1).
// passes: L2-blocked passes, each over its range of the gathered rows, or
// 0 for as many as the bytes the gather reads call for (passes_for: the
// packed rows where the payloads pack, else w0 + w1); pairs: 16-byte
// aligned scratch of nx packed rows (gb_permute_pair_bytes) where the two
// payloads pack (both aligned to their widths), else unused.
extern "C" int gb_permute_gather(const void* perm, int perm_bytes, int64_t n,
                                 const void* x0, void* out0, int64_t w0,
                                 const void* x1, void* out1, int64_t w1,
                                 int64_t nx, int64_t passes, void* pairs,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((perm_bytes != 4 && perm_bytes != 8) || w0 <= 0 || w1 < 0 ||
      nx <= 0 || passes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Payload a = payload(x0, out0, w0);
  const int two = w1 > 0;
  const Payload b = two ? payload(x1, out1, w1) : a;
  const int64_t pair = two ? gb_permute_pair_bytes(w0, w1) : 0;
  const bool pack = pair && a.k == 1 && b.k == 1;
  if (pack && (!pairs || reinterpret_cast<uintptr_t>(pairs) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (passes == 0) passes = passes_for(nx, pack ? pair : w0 + w1);
  cudaError_t e;
  if (pack)
    e = perm_bytes == 4
            ? launch_pairs_by_width<int32_t>(perm, n, a, b, nx, passes,
                                             pairs, s)
            : launch_pairs_by_width<int64_t>(perm, n, a, b, nx, passes,
                                             pairs, s);
  else
    e = perm_bytes == 4
            ? launch_rows<int32_t>(perm, n, a, b, two, nx, passes, s)
            : launch_rows<int64_t>(perm, n, a, b, two, nx, passes, s);
  if (e == cudaSuccess && passes > 1) {
    if (pack) {
      e = demote(pairs, nx * pair, s);
    } else {
      e = demote(x0, nx * w0, s);
      if (e == cudaSuccess && two) e = demote(x1, nx * w1, s);
    }
  }
  return static_cast<int>(e == cudaSuccess ? cudaGetLastError() : e);
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

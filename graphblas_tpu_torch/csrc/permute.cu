// Hand-written Hopper (sm_90a) gather-permute kernel for graphblas_tpu_torch
// (kernels/static_route.py): out[p] = x[perm[p]] over 32-bit elements.
//
// Replaces the static permutation executors of graphblas_tpu/kernels/
// static_route.py: sublane_permute (per-lane Benes networks on an (R, 128)
// tile), tile_permute (lane gather, sublane Benes, lane gather) and
// global_permute (two Clos-routed passes over (2048, 128) tiles).  Those
// route a permutation through fixed networks because the TPU's TensorCore
// cannot gather; Hopper gathers from device memory directly, so the port
// takes the permutation itself and reads x once through it.
//
// What bounds it on an H100: each output reads one index (4 B) and one
// element (4 B) and writes one element (4 B): 12 B per element of
// device-memory traffic at 3.35 TB/s.  The element reads follow the
// permutation and are scattered, so their 32-byte sectors are mostly
// fetched for one element each; the design keeps everything else
// streaming: one thread per 4 outputs, neighbouring threads on
// neighbouring outputs, four index loads and a 16-byte store per thread.
//
// The launcher returns cudaGetLastError(), launches on the stream it is
// given, allocates nothing and does not synchronise.  The caller checks
// that every index lies in [0, number of x elements).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
permute_gather_32(const uint32_t* __restrict__ x,
                  const int32_t* __restrict__ perm,
                  uint32_t* __restrict__ out, int64_t n) {
  const int64_t q = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t p = q * 4;
  if (p + 4 <= n) {
    uint4 o;
    o.x = __ldg(x + perm[p]);
    o.y = __ldg(x + perm[p + 1]);
    o.z = __ldg(x + perm[p + 2]);
    o.w = __ldg(x + perm[p + 3]);
    *reinterpret_cast<uint4*>(out + p) = o;
  } else {
    for (int64_t i = p; i < n; ++i) out[i] = __ldg(x + perm[i]);
  }
}

}  // namespace

// out (16-byte aligned) receives n elements; x and out hold 32-bit
// elements of any type.
extern "C" int gb_permute_gather_32(const void* x, const void* perm,
                                    void* out, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  permute_gather_32<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(perm),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The staging and storing helpers of the tile programs (plasma_tile.cuh,
// plasma3d_tile.cuh), written once for the card and for the host: on the
// card 1-D TMA copies on an mbarrier, cp.async and 16-B vector stores; on
// the host (the CPU tests of the tile programs) plain copies, and the
// thread loops become serial loops over the same indices.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define TILE_FOR(t, n) \
  for (int t = static_cast<int>(threadIdx.x); t < (n); t += static_cast<int>(blockDim.x))
#define TILE_SYNC() __syncthreads()
#else
#include <vector>
#define TILE_FOR(t, n) for (int t = 0; t < (n); ++t)
#define TILE_SYNC() ((void)0)
#endif

namespace {

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

__device__ __forceinline__ void bar_init(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
#else
  (void)bar;
#endif
}

// one arrival that expects `bytes` of TMA transactions (0: the arrival
// alone completes the phase)
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
#else
  (void)bar;
  (void)bytes;
#endif
}

// wait until the barrier's phase of this parity has completed; a barrier
// that never completes traps (a failed launch) instead of hanging
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
#if defined(__CUDA_ARCH__)
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (spins > (1u << 24)) __trap();
  }
#else
  (void)bar;
  (void)parity;
#endif
}

// a 1-D TMA copy of `bytes` (a multiple of 16, both ends 16-B aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
#else
  (void)bar;
  std::memcpy(dst, src, bytes);
#endif
}

// one element: cp.async where it is 4 or 8 B, through registers otherwise
template <typename U>
__device__ __forceinline__ void elem_copy(U* dst, const U* src) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(U) == 4 || sizeof(U) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(sizeof(U))
                 : "memory");
  } else {
    *dst = *src;
  }
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// all of this thread's cp.async groups but the newest have landed
__device__ __forceinline__ void async_wait_prev() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// orders this thread's ordinary (generic-proxy) memory accesses with its
// TMA (async-proxy) ones: a launch that reads by TMA what it wrote with
// ordinary stores fences on both sides of the grid barrier between them
__device__ __forceinline__ void proxy_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#else
  std::memcpy(dst, src, 16);
#endif
}

// Lane 0 of each warp runs body(q) for every warps-th q < n: a TMA copy
// takes uniform registers, so the lanes of one warp would issue theirs one
// after another. On the host, every q in turn.
template <typename Body>
__device__ __forceinline__ void per_warp(int n, Body&& body) {
#if defined(__CUDA_ARCH__)
  if ((threadIdx.x & 31) == 0)
    for (int q = static_cast<int>(threadIdx.x >> 5); q < n;
         q += static_cast<int>(blockDim.x >> 5))
      body(q);
#else
  for (int q = 0; q < n; ++q) body(q);
#endif
}

}  // namespace

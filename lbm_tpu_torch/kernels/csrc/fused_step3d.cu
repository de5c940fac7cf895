// Periodic D3Q19 collide + push-stream for the three-species plasma column,
// one pass over device memory per step, and its halo form for a shard of a
// sharded column.
//
// Replaces lbm_tpu/kernels/fused_step3d.py:collide_stream3d (and, at wide
// cross-sections, the VMEM workarounds fused_split3d.collide_stream3d_f/_g
// and fused_panel3d.collide_stream_panel3d). It computes what that kernel
// computes: ops/d3.update_macro3 + collide_species_dirs3 + periodic
// push-streaming, and rho_q. It is not the TPU's z-slice software pipeline
// carried over (its fb0/fb1/zlast wrap scratch and in-place aliasing exist
// to fit VMEM): one thread owns one site, x fastest, so the loads of one
// direction plane coalesce; the per-site work is plasma3d_site.cuh's
// collide_stream_site3d. No in-place update: a push-stream in place races,
// so the wrapper hands in fresh output buffers.
//
// Bound: every call reads and writes all of f and g, 114 + 114 values a
// site, plus E (3 values) and rho_q: 928 B/site in f32, 472 in bf16, 1856
// in f64, against ~6,000 flop a site: bytes-bound on an H100 in every
// mode. This first version moves each value once in and once out, reading
// f and g a second time from the caches; tiling and wide loads are left to
// later work.

#include "halo3d_site.cuh"
#include "plasma3d_site.cuh"

namespace {

template <typename S, typename T, bool DELTA, bool FAST>
__global__ void collide_stream3d_kernel(const S* __restrict__ f, const S* __restrict__ g,
                                        const T* __restrict__ Ex, const T* __restrict__ Ey,
                                        const T* __restrict__ Ez, S* __restrict__ f_out,
                                        S* __restrict__ g_out, T* __restrict__ rho_q, int NZ,
                                        int NY, int NX, const Params<T> p) {
  const int64_t vol = static_cast<int64_t>(NZ) * NY * NX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (site >= vol) return;
  collide_stream_site3d<S, T, DELTA, FAST>(f, g, Ex, Ey, Ez, f_out, g_out, rho_q, NZ, NY, NX,
                                           site, p);
}

template <typename S, typename T, bool DELTA, bool FAST>
cudaError_t launch(const void* f, const void* g, const void* Ex, const void* Ey, const void* Ez,
                   void* f_out, void* g_out, void* rho_q, int NZ, int NY, int NX,
                   const HostParams& hp, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t sites = static_cast<int64_t>(NZ) * NY * NX;
  const unsigned blocks = static_cast<unsigned>((sites + kThreads - 1) / kThreads);
  collide_stream3d_kernel<S, T, DELTA, FAST><<<blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(f), static_cast<const S*>(g), static_cast<const T*>(Ex),
      static_cast<const T*>(Ey), static_cast<const T*>(Ez), static_cast<S*>(f_out),
      static_cast<S*>(g_out), static_cast<T*>(rho_q), NZ, NY, NX, cast_params<T>(hp));
  return cudaGetLastError();
}

template <typename S, typename T, bool FAST>
cudaError_t launch_delta(int delta, const void* f, const void* g, const void* Ex,
                         const void* Ey, const void* Ez, void* f_out, void* g_out, void* rho_q,
                         int NZ, int NY, int NX, const HostParams& hp, cudaStream_t stream) {
  return delta ? launch<S, T, true, FAST>(f, g, Ex, Ey, Ez, f_out, g_out, rho_q, NZ, NY, NX,
                                          hp, stream)
               : launch<S, T, false, FAST>(f, g, Ex, Ey, Ez, f_out, g_out, rho_q, NZ, NY, NX,
                                           hp, stream);
}

// The halo step: one thread a site of the shard's extended block
// (halo3d_site.cuh). Replaces lbm_tpu/kernels/fused_step3d.py:
// collide_stream_halo3d (zh = 1, yh = 0: a z-shard with its neighbours'
// slices), fused_panel3d.py:collide_stream_panel3d with halo_rows (zh = 0,
// yh = 1: a y-shard with their rows) and fused_panel3d.py:
// collide_stream_panel3d_zhalo (zh = yh = 1: a (dz, dy) tile with slices,
// rows and corner lines); the TPU's y-panels and z-slice pipeline exist to
// fit VMEM and are not carried over. Bound as the periodic kernel (928 /
// 472 / 1856 B a shard site), plus each strip site read once: bytes-bound.
// The halo sites are collided again, which costs (2 zh NY + 2 yh NZ) NX
// extra sites' operations and no extra bytes written.
template <typename S, typename T, bool DELTA, bool FAST>
__global__ void collide_stream_halo3d_kernel(const Halo3In<S, T> in, S* __restrict__ f_out,
                                             S* __restrict__ g_out, T* __restrict__ rho_q,
                                             const Halo3Geom gm, const Params<T> p) {
  const int64_t esite = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (esite >= halo3d_sites(gm)) return;
  collide_stream_halo3d_site<S, T, DELTA, FAST>(in, f_out, g_out, rho_q, gm, esite, p);
}

template <typename S, typename T>
Halo3In<S, T> halo3d_in(const void* const* ptr) {
  Src3<S, T> src[9];
  for (int k = 0; k < 9; ++k)
    src[k] = {static_cast<const S*>(ptr[5 * k]), static_cast<const S*>(ptr[5 * k + 1]),
              static_cast<const T*>(ptr[5 * k + 2]), static_cast<const T*>(ptr[5 * k + 3]),
              static_cast<const T*>(ptr[5 * k + 4])};
  return {src[0], src[1], src[2], src[3], src[4], src[5], src[6], src[7], src[8]};
}

template <typename S, typename T, bool DELTA, bool FAST>
cudaError_t launch_halo(const void* const* ptr, void* f_out, void* g_out, void* rho_q,
                        const Halo3Geom& gm, const HostParams& hp, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const unsigned blocks = static_cast<unsigned>((halo3d_sites(gm) + kThreads - 1) / kThreads);
  collide_stream_halo3d_kernel<S, T, DELTA, FAST><<<blocks, kThreads, 0, stream>>>(
      halo3d_in<S, T>(ptr), static_cast<S*>(f_out), static_cast<S*>(g_out),
      static_cast<T*>(rho_q), gm, cast_params<T>(hp));
  return cudaGetLastError();
}

template <typename S, typename T, bool FAST>
cudaError_t launch_halo_delta(int delta, const void* const* ptr, void* f_out, void* g_out,
                              void* rho_q, const Halo3Geom& gm, const HostParams& hp,
                              cudaStream_t stream) {
  return delta ? launch_halo<S, T, true, FAST>(ptr, f_out, g_out, rho_q, gm, hp, stream)
               : launch_halo<S, T, false, FAST>(ptr, f_out, g_out, rho_q, gm, hp, stream);
}

}  // namespace

// mode: 0 = f64 storage and compute, 1 = f32, 2 = bf16 storage with f32
// compute. delta: nonzero when the neutral's f is delta-stored. f, g:
// (3, 19, NZ, NY, NX); Ex, Ey, Ez, rho_q: (NZ, NY, NX). Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream` and the caller owns every buffer.
extern "C" int lbm_plasma3d_collide_stream(int mode, int delta, const void* f, const void* g,
                                           const void* Ex, const void* Ey, const void* Ez,
                                           void* f_out, void* g_out, void* rho_q, int NZ,
                                           int NY, int NX, const HostParams* hp,
                                           void* stream) {
  if (NZ <= 0 || NY <= 0 || NX <= 0 || hp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_delta<double, double, false>(delta, f, g, Ex, Ey, Ez, f_out, g_out, rho_q,
                                                 NZ, NY, NX, *hp, st);
    case 1:
      return launch_delta<float, float, false>(delta, f, g, Ex, Ey, Ez, f_out, g_out, rho_q,
                                               NZ, NY, NX, *hp, st);
    case 2:
      return launch_delta<__nv_bfloat16, float, true>(delta, f, g, Ex, Ey, Ez, f_out, g_out,
                                                      rho_q, NZ, NY, NX, *hp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The halo step of one shard. ptr: 45 device pointers, (f, g, Ex, Ey, Ez) of
// the shard, then of the slices above and below it, the rows above and
// below it, and the corner lines above and below the shard inside the slice
// above, then inside the slice below (null where the geometry has no such
// strip). geom: NZ, NY, NX of the shard, zh and yh (0 or 1 each). The shard
// is (3, 19, NZ, NY, NX) and (NZ, NY, NX); a slice (3, 19, NY, NX) and
// (NY, NX); a row (3, 19, NZ, NX) and (NZ, NX); a corner line (3, 19, NX)
// and (NX,), each contiguous. mode and delta as
// lbm_plasma3d_collide_stream.
extern "C" int lbm_plasma3d_collide_stream_halo(int mode, int delta, const void* const* ptr,
                                                void* f_out, void* g_out, void* rho_q,
                                                const int* geom, const HostParams* hp,
                                                void* stream) {
  if (ptr == nullptr || geom == nullptr || hp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Halo3Geom gm{geom[0], geom[1], geom[2], geom[3], geom[4]};
  if (gm.NZ <= 0 || gm.NY <= 0 || gm.NX <= 0 || (gm.zh != 0 && gm.zh != 1) ||
      (gm.yh != 0 && gm.yh != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 9; ++k) {
    const bool z = k == 1 || k == 2, y = k == 3 || k == 4, corner = k >= 5;
    const bool needed = k == 0 || (z && gm.zh) || (y && gm.yh) || (corner && gm.zh && gm.yh);
    for (int j = 0; j < 5; ++j)
      if (needed && ptr[5 * k + j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_halo_delta<double, double, false>(delta, ptr, f_out, g_out, rho_q, gm, *hp,
                                                      st);
    case 1:
      return launch_halo_delta<float, float, false>(delta, ptr, f_out, g_out, rho_q, gm, *hp,
                                                    st);
    case 2:
      return launch_halo_delta<__nv_bfloat16, float, true>(delta, ptr, f_out, g_out, rho_q, gm,
                                                           *hp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Periodic D3Q19 collide + push-stream for the three-species plasma column,
// one pass over device memory per step, and its halo form for a shard of a
// sharded column: one kernel, the tile program of plasma3d_tile.cuh.
//
// Replaces lbm_tpu/kernels/fused_step3d.py:collide_stream3d (and, at wide
// cross-sections, the VMEM workarounds fused_split3d.collide_stream3d_f/_g
// and fused_panel3d.collide_stream_panel3d), fused_step3d.py:
// collide_stream_halo3d (zh = 1, yh = 0: a z-shard with its neighbours'
// slices), fused_panel3d.py:collide_stream_panel3d with halo_rows (zh = 0,
// yh = 1: a y-shard with their rows) and fused_panel3d.py:
// collide_stream_panel3d_zhalo (zh = yh = 1: a (dz, dy) tile with slices,
// rows and corner lines). It computes what those kernels compute:
// ops/d3.update_macro3 + collide_species_dirs3 + push-streaming, and rho_q.
// It is not the TPU's z-slice software pipeline or y-panels carried over
// (they exist to fit VMEM): a persistent block walks over runs of W x-sites
// of a row, staged in shared memory by TMA with two stages in flight, and
// spreads a run over (site, species) threads (plasma3d_tile.cuh). No
// in-place update: a push-stream in place races, so the wrapper hands in
// fresh output buffers.
//
// Bound: every call reads and writes all of f and g, 114 + 114 values a
// site, plus E (3 values) and rho_q: 928 B/site in f32, 472 in bf16, 1856
// in f64, plus each strip site read once (114 + 3 values); beside it an
// issue floor, the instructions a site of the compiled body over the SMs'
// issue rates (scripts/trace_plasma3d_torch.py counts them). The halo
// geometries collide their strip sites again, (2 zh NY + 2 yh NZ) NX sites'
// operations and no bytes written, and every run collides its two
// x-neighbours again, (W + 2) / W of the operations.

#include "plasma3d_tile.cuh"

namespace {

static_assert(kThreads3<float> >= kS * kRun3<float> + 2 * kS, "a thread a task");
static_assert(kThreads3<double> >= kS * kRun3<double> + 2 * kS, "a thread a task");

template <typename S, typename T, bool DELTA, bool FAST>
__global__ void __launch_bounds__(kThreads3<S>, 2)
    plasma3d_tiles_kernel(const __grid_constant__ Tile3Args<S, T> a,
                          const __grid_constant__ Params<T> p) {
  tile3_block<S, T, DELTA, FAST>(a, p);
}

// A persistent grid of as many blocks as the SMs hold (at most one a run).
// A failed attribute or launch returns its error: there is no other route.
template <typename S, typename T, bool DELTA, bool FAST>
cudaError_t launch_tiles(Tile3Args<S, T> a, const HostParams& hp, cudaStream_t stream) {
  using L = Tile3Smem<S, T>;
  const auto kernel = plasma3d_tiles_kernel<S, T, DELTA, FAST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads3<S>,
                                                           L::kBytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  a.aligned = tile3_aligned(a);
  const int64_t runs = tile3_runs<S>(a.gm);
  if (runs >= (int64_t{1} << 30)) return cudaErrorInvalidValue;
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(runs < cap ? runs : cap);
  constexpr int threads = kThreads3<S>;
  kernel<<<blocks, threads, L::kBytes, stream>>>(a, cast_params<T>(hp));
  return cudaGetLastError();
}

template <typename S, typename T>
Tile3Args<S, T> tile3_args(const void* const* ptr, void* f_out, void* g_out, void* rho_q,
                           const Geom3& gm) {
  Tile3Args<S, T> a{};
  for (int k = 0; k < 9; ++k)
    a.src[k] = {static_cast<const S*>(ptr[5 * k]), static_cast<const S*>(ptr[5 * k + 1]),
                static_cast<const T*>(ptr[5 * k + 2]), static_cast<const T*>(ptr[5 * k + 3]),
                static_cast<const T*>(ptr[5 * k + 4])};
  a.f_out = static_cast<S*>(f_out);
  a.g_out = static_cast<S*>(g_out);
  a.rho_q = static_cast<T*>(rho_q);
  a.gm = gm;
  return a;
}

int launch_mode(int mode, int delta, const void* const* ptr, void* f_out, void* g_out,
                void* rho_q, const Geom3& gm, const HostParams& hp, cudaStream_t st) {
  switch (mode) {
    case 0: {
      const auto a = tile3_args<double, double>(ptr, f_out, g_out, rho_q, gm);
      return delta ? launch_tiles<double, double, true, false>(a, hp, st)
                   : launch_tiles<double, double, false, false>(a, hp, st);
    }
    case 1: {
      const auto a = tile3_args<float, float>(ptr, f_out, g_out, rho_q, gm);
      return delta ? launch_tiles<float, float, true, false>(a, hp, st)
                   : launch_tiles<float, float, false, false>(a, hp, st);
    }
    case 2: {
      const auto a = tile3_args<__nv_bfloat16, float>(ptr, f_out, g_out, rho_q, gm);
      return delta ? launch_tiles<__nv_bfloat16, float, true, true>(a, hp, st)
                   : launch_tiles<__nv_bfloat16, float, false, true>(a, hp, st);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const void* ptr[45] = {f, g, Ex, Ey, Ez};
  return launch_mode(mode, delta, ptr, f_out, g_out, rho_q, Geom3{NZ, NY, NX, 0, 0}, *hp,
                     static_cast<cudaStream_t>(stream));
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
  const Geom3 gm{geom[0], geom[1], geom[2], geom[3], geom[4]};
  if (gm.NZ <= 0 || gm.NY <= 0 || gm.NX <= 0 || (gm.zh != 0 && gm.zh != 1) ||
      (gm.yh != 0 && gm.yh != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 9; ++k) {
    const bool z = k == 1 || k == 2, y = k == 3 || k == 4, corner = k >= 5;
    const bool needed = k == 0 || (z && gm.zh) || (y && gm.yh) || (corner && gm.zh && gm.yh);
    for (int j = 0; j < 5; ++j)
      if (needed && ptr[5 * k + j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mode(mode, delta, ptr, f_out, g_out, rho_q, gm, *hp,
                     static_cast<cudaStream_t>(stream));
}

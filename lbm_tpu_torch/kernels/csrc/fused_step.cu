// Periodic D2Q9 collide + push-stream for the three-species plasma, one
// pass over device memory per step, and the same kernel without the stream.
//
// Replaces lbm_tpu/kernels/fused_step.py:collide_stream (the Pallas kernel
// body _make_kernel) and, with the stream off (entry lbm_collide),
// lbm_tpu/kernels/collide_pallas.py:fused_collide, which collides only and
// leaves streaming to the caller. It computes what that kernel computes,
// which is lbm_tpu/ops/macros.update_macro + ops/equilibrium + ops/collide
// + periodic push-streaming, and returns rho_q. It is not the TPU's band
// pipeline carried over: a persistent block walks over runs of W x-sites of
// a row, staged in shared memory by TMA with two stages in flight, a
// thread a site, which stores each value straight to its destination
// (plasma_tile.cuh, the same program as the K-step window kernel's collide
// stage). No in-place update: the TPU
// kernel aliases its outputs onto its inputs, but a push-stream in place
// races on a GPU, so the wrapper hands in fresh output buffers. Numbers
// and build flags: plasma_site.cuh.
//
// The third mode, the halo step (entry lbm_collide_stream_halo), replaces
// lbm_tpu/kernels/fused_step.py:collide_stream_halo (a y-shard with
// neighbour strips) and :collide_stream_halo2d (a (y, x) tile with
// corner-extended y strips and x strips): one thread per site of the
// shard's block extended by the neighbours' edge rows (and columns), which
// collides with plasma_site.cuh's collide_site and pushes into the shard
// only (csrc/halo_site.cuh). Its output equals this kernel's on the full
// grid, bit for bit, at every shard site. Its traffic is the periodic
// kernel's plus the strips' edge rows.
//
// Bound: every call reads and writes all of f and g, 27+27 values a site,
// which is 432 B/site in f32 (216 B/site in bf16) plus 12 B of Ex, Ey and
// rho_q; beside it an issue floor, the instructions of the compiled body a
// site over the SMs' issue rates (scripts/trace_plasma2d_torch.py counts
// them).

#include "halo_site.cuh"
#include "plasma_tile.cuh"

namespace {

template <typename S, typename T, bool DELTA, bool FAST>
__global__ void __launch_bounds__(kThreads2<S>, 3)
    plasma_tiles_kernel(const __grid_constant__ Tile2Args<S, T> a,
                        const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(128) unsigned char sm[];
  tile2_setup<S, T>(sm, static_cast<const T*>(nullptr));
  uint32_t seq = 0;
  tile2_block<S, T, DELTA, FAST, false>(a, p, sm, seq);
}

// A persistent grid of at most as many blocks as the SMs hold (tile2_blocks).
// A failed attribute or launch returns its error: there is no other route.
template <typename S, typename T, bool DELTA, bool FAST>
cudaError_t launch_tiles(Tile2Args<S, T> a, const HostParams& hp, cudaStream_t stream) {
  using L = Tile2Smem<S, T>;
  const auto kernel = plasma_tiles_kernel<S, T, DELTA, FAST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads2<S>,
                                                           L::kBytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  a.aligned = tile2_aligned(a);
  const unsigned blocks = static_cast<unsigned>(
      tile2_blocks(tile2_runs<S>(a.band), static_cast<int64_t>(per_sm) * sms));
  kernel<<<blocks, kThreads2<S>, L::kBytes, stream>>>(a, cast_params<T>(hp));
  return cudaGetLastError();
}

// stream: 1 push-streams periodically; 0 stores each value at its site.
template <typename S, typename T, bool FAST>
cudaError_t launch_delta(int delta, int stream_on, const void* f, const void* g, const void* Ex,
                         const void* Ey, void* f_out, void* g_out, void* rho_q, int NY, int NX,
                         const HostParams& hp, cudaStream_t stream) {
  Tile2Args<S, T> a{};
  a.f = static_cast<const S*>(f);
  a.g = static_cast<const S*>(g);
  a.ex = static_cast<const T*>(Ex);
  a.ey = static_cast<const T*>(Ey);
  a.f_out = static_cast<S*>(f_out);
  a.g_out = static_cast<S*>(g_out);
  a.rho_q = static_cast<T*>(rho_q);
  a.band = {NY, NX, 0, -1, -1};
  a.stream = stream_on;
  return delta ? launch_tiles<S, T, true, FAST>(a, hp, stream)
               : launch_tiles<S, T, false, FAST>(a, hp, stream);
}

template <typename S, typename T, bool DELTA, bool FAST>
__global__ void collide_stream_halo_kernel(const HaloIn<S, T> in, S* __restrict__ f_out,
                                           S* __restrict__ g_out, T* __restrict__ rho_q_out,
                                           const HaloGeom gm, const Params<T> p) {
  const int64_t esite = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (esite >= halo_sites(gm)) return;
  collide_stream_halo_site<S, T, DELTA, FAST>(in, f_out, g_out, rho_q_out, gm, esite, p);
}

template <typename S, typename T, bool DELTA, bool FAST>
cudaError_t launch_halo(const void* const* ptr, void* f_out, void* g_out, void* rho_q,
                        const HaloGeom& gm, const HostParams& hp, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const auto pop = [&](int k) { return static_cast<const S*>(ptr[k]); };
  const auto fld = [&](int k) { return static_cast<const T*>(ptr[k]); };
  // pointer order: (f, g, Ex, Ey) of the shard, then of up, dn, lt, rt
  const HaloIn<S, T> in{pop(0),  pop(1),  fld(2),  fld(3),  pop(4),  pop(5),  fld(6),
                        fld(7),  pop(8),  pop(9),  fld(10), fld(11), pop(12), pop(13),
                        fld(14), fld(15), pop(16), pop(17), fld(18), fld(19)};
  const unsigned blocks = static_cast<unsigned>((halo_sites(gm) + kThreads - 1) / kThreads);
  collide_stream_halo_kernel<S, T, DELTA, FAST><<<blocks, kThreads, 0, stream>>>(
      in, static_cast<S*>(f_out), static_cast<S*>(g_out), static_cast<T*>(rho_q), gm,
      cast_params<T>(hp));
  return cudaGetLastError();
}

template <typename S, typename T, bool FAST>
cudaError_t launch_halo_delta(int delta, const void* const* ptr, void* f_out, void* g_out,
                              void* rho_q, const HaloGeom& gm, const HostParams& hp,
                              cudaStream_t stream) {
  return delta ? launch_halo<S, T, true, FAST>(ptr, f_out, g_out, rho_q, gm, hp, stream)
               : launch_halo<S, T, false, FAST>(ptr, f_out, g_out, rho_q, gm, hp, stream);
}

}  // namespace

// mode: 0 = f64 storage and compute, 1 = f32, 2 = bf16 storage with f32
// compute. delta: nonzero when the neutral's f is delta-stored. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream` and the caller owns every buffer.
extern "C" int lbm_collide_stream(int mode, int delta, const void* f, const void* g,
                                  const void* Ex, const void* Ey, void* f_out, void* g_out,
                                  void* rho_q, int NY, int NX, const HostParams* hp,
                                  void* stream) {
  if (NY <= 0 || NX <= 0 || static_cast<int64_t>(NY) * NX > INT32_MAX || hp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_delta<double, double, false>(delta, 1, f, g, Ex, Ey, f_out, g_out, rho_q,
                                                 NY, NX, *hp, st);
    case 1:
      return launch_delta<float, float, false>(delta, 1, f, g, Ex, Ey, f_out, g_out, rho_q, NY,
                                               NX, *hp, st);
    case 2:
      return launch_delta<__nv_bfloat16, float, true>(delta, 1, f, g, Ex, Ey, f_out, g_out,
                                                      rho_q, NY, NX, *hp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Collide only: as lbm_collide_stream, but every post-collision value is
// stored at its own site. mode: 0 = f64, 1 = f32 (no bf16 storage, as the
// TPU kernel).
extern "C" int lbm_collide(int mode, int delta, const void* f, const void* g, const void* Ex,
                           const void* Ey, void* f_out, void* g_out, void* rho_q, int NY,
                           int NX, const HostParams* hp, void* stream) {
  if (NY <= 0 || NX <= 0 || static_cast<int64_t>(NY) * NX > INT32_MAX || hp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_delta<double, double, false>(delta, 0, f, g, Ex, Ey, f_out, g_out, rho_q,
                                                 NY, NX, *hp, st);
    case 1:
      return launch_delta<float, float, false>(delta, 0, f, g, Ex, Ey, f_out, g_out, rho_q, NY,
                                               NX, *hp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The halo step of one shard. ptr: 20 device pointers, (f, g, Ex, Ey) of
// the shard, then of the up, dn, lt and rt strips (the last eight null on
// a y-shard). geom: NY, NX of the shard, the up and dn strips' depths, the
// y strips' corner extension (0 on a y-shard, whose x wraps; >= 1 on a
// tile) and the lt and rt strips' widths. mode and delta as
// lbm_collide_stream.
extern "C" int lbm_collide_stream_halo(int mode, int delta, const void* const* ptr,
                                       void* f_out, void* g_out, void* rho_q,
                                       const int* geom, const HostParams* hp, void* stream) {
  if (ptr == nullptr || geom == nullptr || hp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const HaloGeom gm{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6]};
  const bool tile = gm.ext > 0;
  if (gm.NY <= 0 || gm.NX <= 0 || gm.du < 1 || gm.dd < 1 || gm.ext < 0 ||
      (tile && (gm.dl < 1 || gm.dr < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < (tile ? 20 : 12); ++k)
    if (ptr[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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

// sizeof(HostParams), so the wrapper can check that its ctypes mirror matches.
extern "C" int lbm_host_params_size() { return static_cast<int>(sizeof(HostParams)); }

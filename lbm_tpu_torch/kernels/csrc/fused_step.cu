// Periodic D2Q9 collide + push-stream for the three-species plasma, one
// pass over device memory per step, and the same kernel without the stream.
//
// Replaces lbm_tpu/kernels/fused_step.py:collide_stream (the Pallas kernel
// body _make_kernel) and, with STREAM = false (entry lbm_collide),
// lbm_tpu/kernels/collide_pallas.py:fused_collide, which collides only and
// leaves streaming to the caller. It computes what that kernel computes, which is
// lbm_tpu/ops/macros.update_macro + ops/equilibrium + ops/collide +
// periodic push-streaming, and returns rho_q. It is not the TPU's band
// pipeline carried over: one thread owns one lattice site, with x fastest,
// so neighbouring threads touch neighbouring addresses in every (NY, NX)
// plane. The thread loads its 27 f, 27 g, Ex and Ey, collides them with
// plasma_site.cuh's collide_site (shared with the K-step window kernel,
// fused_multistep.cu), and writes each post-collision value to
// ((y+cy) mod NY, (x+cx) mod NX) of the OUTPUT buffers (to (y, x) with
// STREAM = false), and rho_q at (y, x).
// No in-place update: the TPU kernel aliases its outputs onto its inputs,
// but a push-stream in place races on a GPU, so the wrapper hands in fresh
// output buffers. Numbers and build flags: plasma_site.cuh.
//
// Bound: every call reads and writes all of f and g, 27+27 values a site,
// which is 432 B/site in f32 (216 B/site in bf16) plus 12 B of Ex, Ey and
// rho_q, against ~3,000 flop/site: memory-bound on an H100 in f32, close
// to balanced in bf16. This first version does the minimum traffic (each
// value read once and written once) and nothing more: wide loads, shared-
// memory staging and in-place streaming are left to later work.

#include "plasma_site.cuh"

namespace {

// STREAM: push-stream periodically; false stores each value at its site.
template <typename S, typename T, bool DELTA, bool FAST, bool STREAM>
__global__ void collide_stream_kernel(const S* __restrict__ f, const S* __restrict__ g,
                                      const T* __restrict__ Ex_in, const T* __restrict__ Ey_in,
                                      S* __restrict__ f_out, S* __restrict__ g_out,
                                      T* __restrict__ rho_q_out, int NY, int NX,
                                      const Params<T> p) {
  const int64_t plane = static_cast<int64_t>(NY) * NX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (site >= plane) return;
  const int y = static_cast<int>(site / NX);
  const int x = static_cast<int>(site - static_cast<int64_t>(y) * NX);

  T fv[kS][kQ], gv[kS][kQ];
  load_site<S, T>(f, g, plane, site, fv, gv);
  // push-stream destinations: rows and columns of the 3x3 neighbourhood
  const int64_t row[3] = {static_cast<int64_t>(y == 0 ? NY - 1 : y - 1) * NX,
                          static_cast<int64_t>(y) * NX,
                          static_cast<int64_t>(y == NY - 1 ? 0 : y + 1) * NX};
  const int col[3] = {x == 0 ? NX - 1 : x - 1, x, x == NX - 1 ? 0 : x + 1};
  rho_q_out[site] = collide_site<T, DELTA, FAST>(
      fv, gv, Ex_in[site], Ey_in[site], p, [&](int s, const T* fo, const T* go) {
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const int64_t dst =
              (s * kQ + i) * plane + (STREAM ? row[cy_of(i) + 1] + col[cx_of(i) + 1] : site);
          Io<S, T>::store(f_out + dst, fo[i]);
          Io<S, T>::store(g_out + dst, go[i]);
        }
      });
}

template <typename S, typename T, bool DELTA, bool FAST, bool STREAM>
cudaError_t launch(const void* f, const void* g, const void* Ex, const void* Ey, void* f_out,
                   void* g_out, void* rho_q, int NY, int NX, const HostParams& hp,
                   cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t sites = static_cast<int64_t>(NY) * NX;
  const unsigned blocks = static_cast<unsigned>((sites + kThreads - 1) / kThreads);
  collide_stream_kernel<S, T, DELTA, FAST, STREAM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(f), static_cast<const S*>(g), static_cast<const T*>(Ex),
      static_cast<const T*>(Ey), static_cast<S*>(f_out), static_cast<S*>(g_out),
      static_cast<T*>(rho_q), NY, NX, cast_params<T>(hp));
  return cudaGetLastError();
}

template <typename S, typename T, bool FAST, bool STREAM = true>
cudaError_t launch_delta(int delta, const void* f, const void* g, const void* Ex,
                         const void* Ey, void* f_out, void* g_out, void* rho_q, int NY,
                         int NX, const HostParams& hp, cudaStream_t stream) {
  return delta ? launch<S, T, true, FAST, STREAM>(f, g, Ex, Ey, f_out, g_out, rho_q, NY, NX,
                                                  hp, stream)
               : launch<S, T, false, FAST, STREAM>(f, g, Ex, Ey, f_out, g_out, rho_q, NY, NX,
                                                   hp, stream);
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
  if (NY <= 0 || NX <= 0 || hp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_delta<double, double, false>(delta, f, g, Ex, Ey, f_out, g_out, rho_q, NY,
                                                 NX, *hp, st);
    case 1:
      return launch_delta<float, float, false>(delta, f, g, Ex, Ey, f_out, g_out, rho_q, NY,
                                               NX, *hp, st);
    case 2:
      return launch_delta<__nv_bfloat16, float, true>(delta, f, g, Ex, Ey, f_out, g_out, rho_q,
                                                      NY, NX, *hp, st);
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
  if (NY <= 0 || NX <= 0 || hp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_delta<double, double, false, false>(delta, f, g, Ex, Ey, f_out, g_out,
                                                        rho_q, NY, NX, *hp, st);
    case 1:
      return launch_delta<float, float, false, false>(delta, f, g, Ex, Ey, f_out, g_out, rho_q,
                                                      NY, NX, *hp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// sizeof(HostParams), so the wrapper can check that its ctypes mirror matches.
extern "C" int lbm_host_params_size() { return static_cast<int>(sizeof(HostParams)); }

// Spectral Poisson solve with E from k-space: rho_q (NY, NX) f32 ->
// (Ex, Ey) f32, both axes a power of two (the wrapper also asks for
// power-of-two multiples of 128, the TPU kernel's shapes).
//
// Replaces lbm_tpu/kernels/fft_tpu.py:solve_fft_efield_tpu. It computes the
// same function: the periodic Poisson equation with the 5-point eigenvalue
// 4 (sin^2(pi ky/NY) + sin^2(pi kx/NX)), the k = 0 mode zeroed, and E from
// the central-difference symbol (sy - i sx), scaled by 1/(NY NX), so that
// Ex = Re and Ey = Im of one complex inverse transform. The TPU version runs
// permuted four-step transforms (Stockham stages plus 128-point DFTs as MXU
// matmuls) in three panel kernels; on the H100 each line's transform runs
// in shared memory in radix-16 rounds, four stages a barrier, with
// constant in-register twiddles and one table twiddle an element
// (csrc/fft_solve.cuh holds the arithmetic):
//
//   K1  rows_forward_pair: two real rows of rho a complex line, forward
//       over x, each row's spectrum split off  -> tiled complex scratch
//   K2  panel_solve: column panels, forward over y, the k-space multiply,
//       inverse over y, back into the scratch in place
//   K3  rows_inverse_tiled: rows of the scratch, inverse over x -> Ex, Ey
//
// The scratch is tiled by column panels (P columns, 4 to 16 wide up to
// 2048 rows, 2 at 4096, 1 past it: what three blocks an SM, then one,
// hold in shared memory), so K2 reads and
// writes each panel as one contiguous run and K1, K3 move runs of (rows a
// block) * P complex values. K1 transforms half as many lines as there are
// rows: rho is real, so two rows share a complex line and
// A[k] = (Z[k] + conj Z[-k]) / 2, B[k] = (Z[k] - conj Z[-k]) / 2i. The
// longest line a block holds is 16,384 points (132 KB with the bank
// pads); the wrapper refuses longer axes.
//
// Bound: the function reads rho (4 B a site) and writes Ex and Ey (8 B): 12
// B a site, 0.0150 ms at 2048^2 on 3.35 TB/s, against ~2 x 5 N log2 N flop
// for a forward and an inverse 2-D transform, 0.0138 ms at 67 TFLOP/s f32:
// bytes bound it. The three passes move 44 B a site through the complex
// f32 scratch (4 + 8, 8 + 8, 8 + 8); at 2048^2 the 32-MB scratch stays in
// the 50-MB L2. Every four butterfly stages go through shared memory and a
// barrier.

#include <cuda_runtime.h>

#include "fft_solve.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rows_forward_pair(const float* rho, float* scratch, const fftsolve::Tables tb, int NY,
                      int NX, int R, int P) {
  extern __shared__ float smem[];
  float* sim = smem + fftsolve::plane_floats(R, NX);
  fftsolve::rows_forward_pair_block(blockIdx.x, rho, scratch, tb, smem, sim, NY, NX, R, P);
}

__global__ void __launch_bounds__(kThreads)
    panel_solve(float* scratch, const fftsolve::Tables tb, int NY, int NX, int P) {
  extern __shared__ float smem[];
  float* sim = smem + fftsolve::plane_floats(P, NY);
  fftsolve::panel_solve_block(blockIdx.x, scratch, tb, smem, sim, NY, NX, P);
}

__global__ void __launch_bounds__(kThreads)
    rows_inverse_tiled(const float* scratch, float* ex, float* ey, const fftsolve::Tables tb,
                       int NY, int NX, int R, int P) {
  extern __shared__ float smem[];
  float* sim = smem + fftsolve::plane_floats(R, NX);
  fftsolve::rows_inverse_block(blockIdx.x, scratch, ex, ey, tb, smem, sim, NY, NX, R, P);
}

bool pow2(int n) { return n >= 2 && (n & (n - 1)) == 0; }

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int64_t bytes) {
  if (bytes > fftsolve::kMaxSharedBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// rho, tw_x (NX x 2), tw_y (NY x 2), sym_x (NX x 2), sym_y (NY x 2),
// scratch (NY x NX x 2, 8-byte aligned), ex, ey: float32 device pointers. Returns the first
// CUDA error (0 when all three launches were accepted).
extern "C" int lbm_fft_solve_efield(const void* rho, const void* tw_x, const void* tw_y,
                                    const void* sym_x, const void* sym_y, void* scratch,
                                    void* ex, void* ey, int NY, int NX, void* stream) {
  if (!pow2(NY) || !pow2(NX) || NY < 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const fftsolve::Tables tb{static_cast<const float*>(tw_x), static_cast<const float*>(tw_y),
                            static_cast<const float*>(sym_x), static_cast<const float*>(sym_y),
                            1.0f / (static_cast<float>(NY) * static_cast<float>(NX))};
  const int R = fftsolve::rows_per_block(NY, NX);
  const int P = fftsolve::cols_per_panel(NY, NX);
  const int64_t row_bytes = fftsolve::lines_bytes(R, NX);
  const int64_t col_bytes = fftsolve::lines_bytes(P, NY);
  cudaError_t e = allow_shared(rows_forward_pair, row_bytes);
  if (e == cudaSuccess) e = allow_shared(panel_solve, col_bytes);
  if (e == cudaSuccess) e = allow_shared(rows_inverse_tiled, row_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* scr = static_cast<float*>(scratch);

  rows_forward_pair<<<NY / (2 * R), kThreads, row_bytes, st>>>(
      static_cast<const float*>(rho), scr, tb, NY, NX, R, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  panel_solve<<<NX / P, kThreads, col_bytes, st>>>(scr, tb, NY, NX, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rows_inverse_tiled<<<NY / R, kThreads, row_bytes, st>>>(scr, static_cast<float*>(ex),
                                                           static_cast<float*>(ey), tb, NY, NX,
                                                           R, P);
  return static_cast<int>(cudaGetLastError());
}

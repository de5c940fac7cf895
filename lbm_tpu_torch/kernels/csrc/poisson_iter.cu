// Warm-started iterative Poisson solve, the whole sweep loop in one launch:
// red-black Gauss-Seidel, SOR, or the 4-colour 9-point stencil (NPS).
//
// Replaces lbm_tpu/kernels/poisson_iter.py:solve_iter_tpu, whose body is
// lbm_tpu/kernels/fused_multistep.py:solve_iter_val (neumann=None). Like
// that kernel it runs the do-while loop on the device, stopping when
// maxErr < tol or after max_iter sweeps, and returns phi (E is the
// caller's). The TPU kernel keeps phi in VMEM on one core. Here a
// persistent cooperative grid runs the loop in one of two ways, chosen by
// size (lbm_solve_iter_path):
//
//   tiled      one block an SM owns a fixed tile of phi in shared memory,
//              with a ring of copies of its neighbours' sites one deep a
//              colour pass, for the whole solve (poisson_tile.cuh): the
//              colour passes run in place on the tile and the part of the
//              ring they still reach, so a sweep reads the ring once and
//              writes the tile's border once, to one of two planes in
//              global memory; the sweep's one grid barrier carries both
//              the borders and the error's maximum. rho's tile and ring
//              sit beside phi's in shared memory where both fit, else rho
//              is read through the read-only cache. Taken when in-place
//              updates equal the plain sweeps (interior-only, or NX and NY
//              even) and the largest tile with its ring fits a block's
//              shared memory: up to 2,672^2 in f32 and 1,872^2 in f64 on
//              132 SMs (NPS: 2,600^2 and 1,792^2).
//   streaming  poisson_sweep.cuh's sweep_loop: every colour pass walks
//              the whole plane with grid-stride loops between ping-pong
//              buffers and meets at grid.sync(). Odd periodic planes and
//              planes too large for the tiles.
//
// Both are bitwise equal to the plain sweeps of
// lbm_tpu_torch/ops/poisson.py (the headers say how).
//
// Bound: what the inputs need is one read of phi0 and rho and one write of
// phi, plus 8-14 flop a site per sweep run, so the least time is set by the
// operations. The tiled loop moves only tile borders through L2, once a
// sweep; its floor is one grid barrier a sweep (lbm_solve_iter_floor runs
// the loop with no stencil work).

#include "poisson_sweep.cuh"
#include "poisson_tile.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Args {
  SweepArgs<T> sweep;
  int* sweeps;     // sweeps run
};

template <typename T, int KIND, bool INTERIOR>
__global__ void __launch_bounds__(kThreads) solve_iter_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ SweepShared<T, kThreads> sh;
  const int it = sweep_loop<T, KIND, INTERIOR, kThreads>(a.sweep, sh, grid);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.sweeps = it;
}

// Tiled: one block a tile. EMPTY keeps the loop's grid barriers and
// error reduction and drops the stencil work (the barrier floor).
constexpr int kTileThreads = 1024;
constexpr int kMinTileSites = 2048;   // fewer, larger tiles on small planes
constexpr int64_t kMaxTileBytes = 226 * 1024;

template <typename T>
struct TiledArgs {
  SweepArgs<T> sweep;   // scratch and out: the two planes of tile borders
  ptile::Tiling tiling;
  int rho_tiled;        // a copy of rho's tile and ring in shared memory
  int* sweeps;
};

template <typename T, int KIND, bool INTERIOR, bool EMPTY>
__global__ void __launch_bounds__(kTileThreads, 1) solve_tiled_kernel(const TiledArgs<T> a) {
  using U = typename Bits<T>::U;
  constexpr int kColours = KIND == kNPS ? 4 : 2;
  constexpr int D = kColours;   // ptile::ring_depth(KIND)
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  __shared__ U warp_max[kTileThreads / 32];
  __shared__ U block_err;
  const SweepArgs<T>& sw = a.sweep;
  const int NY = sw.NY, NX = sw.NX;
  const int id = blockIdx.x;
  const ptile::Tile t = ptile::tile_of(a.tiling, id);
  const ptile::Coeffs<T> k{sw.omega, sw.one_minus_omega};

  const ptile::Layout L = ptile::layout_of(t, D);
  const bool rho_tiled = a.rho_tiled != 0;
  T* R = S + ptile::tile_floats(t, L);
  if (id == 0 && threadIdx.x < kRing) sw.err_ring[threadIdx.x] = 0;
  if (!EMPTY) {
    ptile::load_tile(sw.phi0, S, t, L, NY, NX);
    if (rho_tiled) ptile::load_tile(sw.rho, R, t, L, NY, NX);
  }
  grid.sync();

  int it = 0, slot = 0;
  T err = Bits<T>::val(Bits<T>::kInf);
  while (it < sw.max_iter && err >= sw.tol) {
    U local = EMPTY ? Bits<T>::kInf : 0;
    if (!EMPTY) {
      // the ring from the previous sweep's borders (the first from phi0)
      if (it > 0) ptile::read_ring((it & 1) ? sw.scratch : sw.out, S, t, L, NY, NX);
      __syncthreads();
      for (int c = 0; c < kColours; ++c) {
        local = ptile::colour_pass<T, KIND, INTERIOR>(S, rho_tiled ? R : sw.rho, rho_tiled, t,
                                                      L, D - 1 - c, NY, NX, c, k, local);
        __syncthreads();
      }
      ptile::publish_border((it & 1) ? sw.out : sw.scratch, S, t, L, NX);
    }
    // the sweep's error: block max, one atomic a block, one grid barrier
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const U o = __shfl_down_sync(0xffffffffu, local, off);
      local = o > local ? o : local;
    }
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
    __syncthreads();
    if (threadIdx.x == 0) {
      U m = warp_max[0];
      for (int w = 1; w < kTileThreads / 32; ++w) m = warp_max[w] > m ? warp_max[w] : m;
      if (m != 0) atomicMax(&sw.err_ring[slot], m);
    }
    grid.sync();
    ++it;
    if (threadIdx.x == 0) {
      block_err = __ldcg(&sw.err_ring[slot]);
      if (id == 0) sw.err_ring[(slot + 2) % kRing] = 0;
    }
    __syncthreads();
    err = Bits<T>::val(block_err);
    __syncthreads();
    slot = (slot + 1) % kRing;
  }
  if (!EMPTY) ptile::store_tile(sw.out, S, t, L, NX);
  if (id == 0 && threadIdx.x == 0) *a.sweeps = it;
}

// The tiling a plane takes on this card (at most a tile an SM), or ty = 0
// when it takes the streaming loop.
inline cudaError_t plan_tiles(int itemsize, int kind, bool interior, int NY, int NX,
                              ptile::Tiling* g) {
  *g = ptile::Tiling{NY, NX, 0, 0};
  if (!ptile::in_place_equals_plain(interior, NY, NX)) return cudaSuccess;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaSuccess;
  const int depth = ptile::ring_depth(kind);
  const int64_t sites = static_cast<int64_t>(NY) * NX;
  const int64_t by_size = sites / kMinTileSites > 1 ? sites / kMinTileSites : 1;
  const int max_tiles = static_cast<int>(by_size < sms ? by_size : sms);
  const ptile::Tiling t = ptile::choose_tiling(NY, NX, depth, max_tiles);
  if (ptile::tile_bytes(t, depth, itemsize) <= kMaxTileBytes) *g = t;
  return cudaSuccess;
}

template <typename T, int KIND, bool INTERIOR, bool EMPTY>
cudaError_t launch_tiled(const TiledArgs<T>& a, cudaStream_t stream) {
  auto kernel = solve_tiled_kernel<T, KIND, INTERIOR, EMPTY>;
  const int64_t bytes =
      ptile::tile_bytes(a.tiling, ptile::ring_depth(KIND), sizeof(T)) * (a.rho_tiled ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads,
                                                      static_cast<size_t>(bytes));
  if (e != cudaSuccess) return e;
  const int tiles = a.tiling.ty * a.tiling.tx;
  if (static_cast<int64_t>(per_sm) * sms < tiles) return cudaErrorCooperativeLaunchTooLarge;
  TiledArgs<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(tiles),
                                  dim3(kTileThreads), params, static_cast<size_t>(bytes), stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, bool EMPTY>
cudaError_t dispatch_tiled(int kind, int interior, const TiledArgs<T>& a, cudaStream_t stream) {
  switch (kind * 2 + (interior ? 1 : 0)) {
    case 0: return launch_tiled<T, kGS, false, EMPTY>(a, stream);
    case 1: return launch_tiled<T, kGS, true, EMPTY>(a, stream);
    case 2: return launch_tiled<T, kSOR, false, EMPTY>(a, stream);
    case 3: return launch_tiled<T, kSOR, true, EMPTY>(a, stream);
    case 4: return launch_tiled<T, kNPS, false, EMPTY>(a, stream);
    case 5: return launch_tiled<T, kNPS, true, EMPTY>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int KIND, bool INTERIOR>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  auto kernel = solve_iter_kernel<T, KIND, INTERIOR>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t sites = static_cast<int64_t>(a.sweep.NY) * a.sweep.NX;
  const int64_t needed = (sites + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  Args<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(kThreads), params, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int kind, int interior, const Args<T>& a, cudaStream_t stream) {
  switch (kind * 2 + (interior ? 1 : 0)) {
    case 0: return launch<T, kGS, false>(a, stream);
    case 1: return launch<T, kGS, true>(a, stream);
    case 2: return launch<T, kSOR, false>(a, stream);
    case 3: return launch<T, kSOR, true>(a, stream);
    case 4: return launch<T, kNPS, false>(a, stream);
    case 5: return launch<T, kNPS, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t solve(bool empty, int kind, int interior, double omega, int max_iter, double tol,
                  const void* phi0, const void* rho, void* scratch, void* out,
                  void* err_ring, void* sweeps, int NY, int NX, cudaStream_t stream) {
  Args<T> a;
  SweepArgs<T>& s = a.sweep;
  s.phi0 = static_cast<const T*>(phi0);
  s.rho = static_cast<const T*>(rho);
  s.scratch = static_cast<T*>(scratch);
  s.out = static_cast<T*>(out);
  s.err_ring = static_cast<typename Bits<T>::U*>(err_ring);
  s.NY = NY;
  s.NX = NX;
  s.max_iter = max_iter;
  s.tol = static_cast<T>(tol);
  s.omega = static_cast<T>(omega);
  s.one_minus_omega = static_cast<T>(1.0 - omega);
  a.sweeps = static_cast<int*>(sweeps);
  ptile::Tiling g;
  cudaError_t e = plan_tiles(sizeof(T), kind, interior != 0, NY, NX, &g);
  if (e != cudaSuccess) return e;
  if (g.ty == 0) return dispatch<T>(kind, interior, a, stream);
  const bool rho_tiled = 2 * ptile::tile_bytes(g, ptile::ring_depth(kind), sizeof(T)) <=
                         kMaxTileBytes;
  const TiledArgs<T> ta{s, g, rho_tiled ? 1 : 0, a.sweeps};
  return empty ? dispatch_tiled<T, true>(kind, interior, ta, stream)
               : dispatch_tiled<T, false>(kind, interior, ta, stream);
}

}  // namespace

// dtype: 0 = double, 1 = float. kind: 0 = GS, 1 = SOR (omega), 2 = NPS.
// phi0, rho: (NY, NX) inputs; scratch, out: (NY, NX) buffers of the same
// type (the streaming loop's ping-pong pair, the tiled loop's two planes of
// tile borders); err_ring: 3 zero-or-garbage 8-byte slots; sweeps: one int. Returns
// the cudaError_t of the launch (0 on success); asynchronous on `stream`.
extern "C" int lbm_solve_iter(int dtype, int kind, int interior_only, double omega,
                              int max_iter, double tol, const void* phi0, const void* rho,
                              void* scratch, void* out, void* err_ring, void* sweeps, int NY,
                              int NX, void* stream) {
  if (NY <= 0 || NX <= 0 || static_cast<int64_t>(NY) * NX > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return solve<double>(false, kind, interior_only, omega, max_iter, tol, phi0, rho, scratch,
                           out, err_ring, sweeps, NY, NX, st);
    case 1:
      return solve<float>(false, kind, interior_only, omega, max_iter, tol, phi0, rho, scratch,
                          out, err_ring, sweeps, NY, NX, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 1 when lbm_solve_iter takes the tiled loop for this plane and kind on
// the current device, 0 when the streaming loop; a negative cudaError_t on
// failure.
extern "C" int lbm_solve_iter_path(int dtype, int kind, int interior_only, int NY, int NX) {
  if (NY <= 0 || NX <= 0 || static_cast<int64_t>(NY) * NX > INT32_MAX || dtype < 0 ||
      dtype > 1 || kind < 0 || kind > 2)
    return -static_cast<int>(cudaErrorInvalidValue);
  ptile::Tiling g;
  const cudaError_t e = plan_tiles(dtype == 0 ? sizeof(double) : sizeof(float), kind,
                                   interior_only != 0, NY, NX, &g);
  return e != cudaSuccess ? -static_cast<int>(e) : (g.ty > 0 ? 1 : 0);
}

// The tiled loop's floor: `sweeps` sweeps of its grid barriers and error
// reduction, on the tiling lbm_solve_iter takes for this plane, with no
// stencil work (no phi or rho is read). Arguments as
// lbm_solve_iter's; fails with cudaErrorInvalidValue on a plane that takes
// the streaming loop.
extern "C" int lbm_solve_iter_floor(int dtype, int kind, int interior_only, int sweeps,
                                    void* scratch, void* err_ring, void* sweeps_out, int NY,
                                    int NX, void* stream) {
  const int path = lbm_solve_iter_path(dtype, kind, interior_only, NY, NX);
  if (path != 1) return path < 0 ? -path : static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return solve<double>(true, kind, interior_only, 0.0, sweeps, 0.0, nullptr, nullptr, scratch,
                         nullptr, err_ring, sweeps_out, NY, NX, st);
  return solve<float>(true, kind, interior_only, 0.0, sweeps, 0.0, nullptr, nullptr, scratch,
                      nullptr, err_ring, sweeps_out, NY, NX, st);
}

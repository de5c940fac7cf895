// The block program of the 2-D plasma's collide + push-stream: the
// per-step kernel (csrc/fused_step.cu: the periodic step, and the collide
// without the stream) and every collide stage of the K-step window
// (csrc/fused_multistep.cu: the periodic whole grid, and a band with
// bounce-back walls), written once for the card and for the host, as
// plasma3d_tile.cuh is. Built by nvcc it is a persistent block that walks
// over runs with a two-stage ring in shared memory; built by a host C++
// compiler (the CPU test of this header) its thread loops become serial
// loops over the same indices and tile2_host runs the runs one after
// another.
//
// Geometry. A band of NY x NX sites (window::Band), periodic in y and x:
//   * without walls, the whole grid of the per-step kernel or the window;
//   * with walls (the window's bounce-back modes), the x walls at x = 0 and
//     x = NX - 1 on every row and the y walls at the rows b and t that the
//     band holds (-1: none): (0, NY - 1) on the whole grid, and the global
//     walls' rows on a shard extended by K ghost rows (the gated window).
//
// The tile. Every row y is cut into runs of W x-sites, [x0, x0 + w),
// w = min(W, NX - x0). The block stages the run's 27 f, 27 g and Ex, Ey
// planes in shared memory, and each of its W threads collides one site of
// the run, all three species (plasma_site.cuh's moments, then
// collide_species species by species, the species known at compile time),
// reading its populations from the stage, and stores each post-collision
// value straight to its destination slot (y + cy, x + cx), wrapped: the
// warp's 32 sites store 32 neighbouring slots of one plane, so every store
// is coalesced, and each slot is written exactly once, by the thread of
// the site its value comes from. Without the stream every value is stored
// at its own site. rho_q, where the caller asks for it, is written at the
// run's sites.
//
// Walls. window::pushes (multistep_site.cuh) stays the one statement of
// where a value goes: its periodic slot, up to three reflected slots, or
// none, and which slots keep their stale values (the corner holes). A site
// that lies near no wall (window::near_wall) pushes periodically; one that
// does stores each value to the slots pushes names: the periodic slot, the
// slots of (opp i) at (y, x), (y, x + cx) and (y + cy, x), and the hole
// (i, y, x), which takes the site's pre-collision f in f_out and its
// post-collision f in g_out (plus neutral_ref * w_i for species 2 under
// delta storage, lbm_tpu/kernels/fused_multistep.py:309-337). Each slot has
// one writer: the decisions are those of the per-site rule. The walls'
// code is compiled only into the kernels of walled bands (WALLS).
//
// Staging. Where every run is 16-B aligned (tile2_aligned: NX * itemsize
// and W * itemsize multiples of 16, every input pointer 16-B aligned), the
// run's 56 planes come by 1-D TMA copies that complete on the stage's
// mbarrier (lane 0 of each warp issues its share); elsewhere every thread
// copies elements with cp.async (bf16 planes, whose 2-B elements cp.async
// cannot move, through registers). Two stages: the next run's copies fly
// while this one collides, so the loads' latency hides behind the
// arithmetic instead of behind more warps. A launch that reads by TMA what
// it wrote itself (the window's steps) fences the proxies on both sides of
// its grid barriers (tile_copy.cuh's proxy_fence).
#pragma once

#include <cstdint>

#include "multistep_site.cuh"
#include "plasma_site.cuh"
#include "tile_copy.cuh"

namespace {

// The run width, a thread a site: 128 sites in f32 and bf16 storage, 64 in
// f64, so that a stage of the f32 and f64 modes holds ~28 KB (bf16 ~14 KB)
// and three blocks fit an SM (runs of 64 sites, six blocks an SM, ran 12%
// slower at 2048^2 f32: scripts/trace_plasma2d_torch.py); the CPU test
// forces small runs.
#ifdef PLASMA_RUN
template <typename S>
constexpr int kRun2 = PLASMA_RUN;
#else
template <typename S>
constexpr int kRun2 = sizeof(S) == 8 ? 64 : 128;
#endif
template <typename S>
constexpr int kThreads2 = kRun2<S>;
constexpr int kPlanes2 = 2 * kS * kQ;   // 27 f and 27 g planes
constexpr int kStaged2 = kPlanes2 + 2;  // and Ex, Ey

// The launch: the inputs and outputs, the band and the mode.
template <typename S, typename T>
struct Tile2Args {
  const S *f, *g;    // (3, 9, NY, NX)
  const T *ex, *ey;  // (NY, NX)
  S *f_out, *g_out;
  T* rho_q;          // (NY, NX), or null: not written
  window::Band band;
  int stream;        // 1: push-stream; 0: store each value at its site
  int zero_E;        // collide with E = 0 (the window's kill quirk)
  int aligned;       // TMA bulk copies (tile2_aligned)
};

// The shared-memory layout of a block: two stages, the parameters, the
// holes' background and the stages' mbarriers. A staged plane holds the
// run at [0, w).
template <typename S, typename T>
struct Tile2Smem {
  static constexpr int W = kRun2<S>;
  static constexpr size_t kStagePops = round16(kPlanes2 * W * sizeof(S));
  static constexpr size_t kStage = round16(kStagePops + 2 * W * sizeof(T));
  static constexpr size_t kParams = 2 * kStage;
  static constexpr size_t kHole = kParams + round16(sizeof(Params<T>));
  static constexpr size_t kBars = kHole + round16(kQ * sizeof(T));
  static constexpr size_t kBytes = kBars + 16;
};

// One run: its row and sites, the row's offset.
struct Run2 {
  int64_t roff;
  int y, x0, w;
};

// (run indices are 32-bit: the C entries refuse 2^31 sites)
template <typename S>
__host__ __device__ inline int tile2_runs(const window::Band& b) {
  constexpr int W = kRun2<S>;
  return b.NY * ((b.NX + W - 1) / W);
}

// The persistent grid for `runs` runs on at most `resident` blocks: the
// fewest blocks that take as few rounds of runs as `resident` would (a
// window's grid barriers cost more the more blocks meet at them).
inline int64_t tile2_blocks(int64_t runs, int64_t resident) {
  const int64_t rounds = (runs + resident - 1) / resident;
  return (runs + rounds - 1) / rounds;
}

// Whether the launch may stage with TMA bulk copies: every run's planes
// start 16-B aligned and hold a multiple of 16 B.
template <typename S, typename T>
__host__ __device__ inline int tile2_aligned(const Tile2Args<S, T>& a) {
  constexpr int W = kRun2<S>;
  const int64_t NX = a.band.NX;
  if ((W * sizeof(S)) % 16 || (W * sizeof(T)) % 16 || (NX * sizeof(S)) % 16 ||
      (NX * sizeof(T)) % 16)
    return 0;
  const auto off = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16; };
  return off(a.f) || off(a.g) || off(a.ex) || off(a.ey) ? 0 : 1;
}

template <typename S, typename T>
__device__ __forceinline__ Run2 run2_of(const Tile2Args<S, T>& a, int r) {
  constexpr int W = kRun2<S>;
  const window::Band& b = a.band;
  const int NX = b.NX;
  const int nxr = (NX + W - 1) / W;
  Run2 u;
  u.y = r / nxr;
  u.x0 = (r - u.y * nxr) * W;
  u.w = NX - u.x0 < W ? NX - u.x0 : W;
  u.roff = static_cast<int64_t>(u.y) * NX;
  return u;
}

// staged plane q of a run in the source: f (q < 27), g, then Ex, Ey
template <typename S, typename T>
__device__ __forceinline__ const S* pop_src2(const Tile2Args<S, T>& a, const Run2& u, int q) {
  const int64_t plane = static_cast<int64_t>(a.band.NY) * a.band.NX;
  return (q < kS * kQ ? a.f + q * plane : a.g + (q - kS * kQ) * plane) + u.roff;
}
template <typename S, typename T>
__device__ __forceinline__ const T* fld_src2(const Tile2Args<S, T>& a, const Run2& u, int k) {
  return (k == 0 ? a.ex : a.ey) + u.roff;
}

// ---- the block program ----

// Issue the copies of run u into stage `st`: its planes by TMA (aligned) or
// by elements, one cp.async group; one arrival on the stage's barrier
// either way.
template <typename S, typename T>
__device__ __forceinline__ void tile2_issue(const Tile2Args<S, T>& a, const Run2& u,
                                            unsigned char* st, uint64_t* bar) {
  using L = Tile2Smem<S, T>;
  S* pops = reinterpret_cast<S*>(st);
  T* flds = reinterpret_cast<T*>(st + L::kStagePops);
  const int w = u.w;
  const uint32_t bytes =
      a.aligned ? static_cast<uint32_t>(w) * (kPlanes2 * sizeof(S) + 2 * sizeof(T)) : 0;
#if defined(__CUDA_ARCH__)
  if (threadIdx.x == 0)
#endif
    bar_expect(bar, bytes);
  if (a.aligned) {
    per_warp(kStaged2, [&](int q) {
      if (q < kPlanes2)
        bulk_copy(pops + q * L::W, pop_src2(a, u, q) + u.x0, w * sizeof(S), bar);
      else
        bulk_copy(flds + (q - kPlanes2) * L::W, fld_src2(a, u, q - kPlanes2) + u.x0,
                  w * sizeof(T), bar);
    });
  } else {
    TILE_FOR(t, kStaged2 * L::W) {
      const int q = t / L::W, e = t - q * L::W;
      if (e >= w) continue;
      if (q < kPlanes2)
        elem_copy(pops + q * L::W + e, pop_src2(a, u, q) + u.x0 + e);
      else
        elem_copy(flds + (q - kPlanes2) * L::W + e, fld_src2(a, u, q - kPlanes2) + u.x0 + e);
    }
  }
  async_commit();
}

// The site j of run u, staged in stage `st`: collide its three species and
// store every value where the stream (and, WALLS, the band's walls) put it.
// WALLS: the band may have walls (a.band.walls); without, no wall code is
// compiled (it cost the periodic kernels 17-23% at 2048^2 where it never
// runs: scripts/trace_plasma2d_torch.py's one-body variant).
template <typename S, typename T, bool DELTA, bool FAST, bool WALLS>
__device__ __forceinline__ void tile2_site(const Tile2Args<S, T>& a, const Run2& u, int j,
                                           const unsigned char* st, const T* hole_bg,
                                           const Params<T>& p) {
  using L = Tile2Smem<S, T>;
  constexpr int W = L::W;
  const S* pops = reinterpret_cast<const S*>(st) + j;
  const T* flds = reinterpret_cast<const T*>(st + L::kStagePops) + j;
  const window::Band& b = a.band;
  const int NY = b.NY, NX = b.NX, y = u.y, x = u.x0 + j;
  const int64_t plane = static_cast<int64_t>(NY) * NX;
  const T ex = a.zero_E ? T(0.0) : flds[0];
  const T ey = a.zero_E ? T(0.0) : flds[W];
  T r[kS], ux[kS], uy[kS], temp[kS], drho_n = T(0);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const Moments<T> m =
        moments<S, T, DELTA>(s, pops + (s * kQ) * W, pops + ((kS + s) * kQ) * W, W, ex, ey, p);
    r[s] = m.r;
    ux[s] = m.ux;
    uy[s] = m.uy;
    temp[s] = m.temp;
    if (DELTA && s == 2) drho_n = m.d;
  }
  // push-stream destinations: rows and columns of the 3x3 neighbourhood
  const int64_t row[3] = {static_cast<int64_t>(window::wrap_y(y - 1, NY)) * NX, u.roff,
                          static_cast<int64_t>(window::wrap_y(y + 1, NY)) * NX};
  const int col[3] = {x == 0 ? NX - 1 : x - 1, x, x == NX - 1 ? 0 : x + 1};
  const window::Site site = window::site_of(y, x, b);
  const bool edge = WALLS && b.walls && window::near_wall(site);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const S* fs = pops + (s * kQ) * W;
    collide_species<S, T, DELTA, FAST>(
        s, r, ux, uy, temp[s], drho_n, ex, ey, fs, pops + ((kS + s) * kQ) * W, W, p,
        [&](int i, T fo, T go) {
          const int64_t periodic = row[cy_of(i) + 1] + col[cx_of(i) + 1];
          if (!a.stream || !edge) {
            const int64_t dst = (s * kQ + i) * plane + (a.stream ? periodic : u.roff + x);
            Io<S, T>::store(a.f_out + dst, fo);
            Io<S, T>::store(a.g_out + dst, go);
            return;
          }
          const unsigned m = window::pushes(i, site);
          const int64_t base = (s * kQ + opp_of(i)) * plane;
          const int64_t to[4] = {(s * kQ + i) * plane + periodic, base + u.roff + x,
                                 base + u.roff + col[cx_of(i) + 1],
                                 base + row[cy_of(i) + 1] + x};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (m & (1u << c)) {
              Io<S, T>::store(a.f_out + to[c], fo);
              Io<S, T>::store(a.g_out + to[c], go);
            }
          }
          if (m & 16u) {
            const int64_t h = (s * kQ + i) * plane + u.roff + x;
            Io<S, T>::store(a.f_out + h, Io<S, T>::load(fs + i * W));
            Io<S, T>::store(a.g_out + h, (DELTA && s == 2) ? fo + hole_bg[i] : fo);
          }
        });
  }
  if (a.rho_q != nullptr) a.rho_q[u.roff + x] = rho_q_of(r[0], r[1], p);
}

#if defined(__CUDACC__)
// Once a launch, before its first run: the holes' background (hole_bg:
// neutral_ref * w_i, or null) into shared memory, the stages' barriers
// initialised.
template <typename S, typename T>
__device__ __forceinline__ void tile2_setup(unsigned char* sm, const T* hole_bg) {
  using L = Tile2Smem<S, T>;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kQ; ++i)
      reinterpret_cast<T*>(sm + L::kHole)[i] = hole_bg != nullptr ? hole_bg[i] : T(0);
    uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
    bar_init(bar);
    bar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The persistent block over one pass of the band: runs blockIdx.x,
// + gridDim.x, ...; a run is staged in stage seq & 1 while the one before
// it collides. seq counts the runs this block has issued in the launch,
// across passes (the stages' barriers keep their phases). WALLS as
// tile2_site.
template <typename S, typename T, bool DELTA, bool FAST, bool WALLS>
__device__ __forceinline__ void tile2_block(const Tile2Args<S, T>& a, const Params<T>& p,
                                            unsigned char* sm, uint32_t& seq) {
  using L = Tile2Smem<S, T>;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  const T* hole_bg = reinterpret_cast<const T*>(sm + L::kHole);
  const int runs = tile2_runs<S>(a.band);
  int r = static_cast<int>(blockIdx.x);
  if (r >= runs) return;
  Run2 u = run2_of(a, r);
  tile2_issue(a, u, sm + (seq & 1) * L::kStage, bar + (seq & 1));
  for (;;) {
    const int rn = r + static_cast<int>(gridDim.x);
    const uint32_t cur = seq, nxt = seq + 1;
    Run2 un;
    if (rn < runs) {
      un = run2_of(a, rn);
      tile2_issue(a, un, sm + (nxt & 1) * L::kStage, bar + (nxt & 1));
    } else {
      async_commit();   // an empty group: wait_group 1 then covers run cur
    }
    bar_wait(bar + (cur & 1), (cur >> 1) & 1);
    async_wait_prev();
    __syncthreads();
    const int j = static_cast<int>(threadIdx.x);
    if (j < u.w)
      tile2_site<S, T, DELTA, FAST, WALLS>(a, u, j, sm + (cur & 1) * L::kStage, hole_bg, p);
    seq = nxt;
    // the stage is read: the next issue may overwrite it
    __syncthreads();
    if (rn >= runs) break;
    r = rn;
    u = un;
  }
}
#else
// The host build: the runs one after another (last to first with
// `reverse`), alternating stages, the sites of a run in order.
template <typename S, typename T, bool DELTA, bool FAST>
void tile2_host(const Tile2Args<S, T>& a, const HostParams& hp, bool reverse = false) {
  using L = Tile2Smem<S, T>;
  std::vector<uint64_t> buf(L::kBytes / 8 + 1);
  unsigned char* sm = reinterpret_cast<unsigned char*>(buf.data());
  const Params<T> p = cast_params<T>(hp);
  T hole_bg[kQ];
  for (int i = 0; i < kQ; ++i) hole_bg[i] = static_cast<T>(hp.neutral_ref * w_of(i));
  const int runs = tile2_runs<S>(a.band);
  for (int k = 0; k < runs; ++k) {
    unsigned char* st = sm + (k & 1) * L::kStage;
    const Run2 u = run2_of(a, reverse ? runs - 1 - k : k);
    tile2_issue(a, u, st, nullptr);
    for (int j = 0; j < u.w; ++j) {
      if (a.band.walls)
        tile2_site<S, T, DELTA, FAST, true>(a, u, j, st, hole_bg, p);
      else
        tile2_site<S, T, DELTA, FAST, false>(a, u, j, st, hole_bg, p);
    }
  }
}
#endif

}  // namespace

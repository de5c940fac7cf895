// The block programs of the cavity kernels (fused_cavity.cu), written once
// for the card and for the host, as plasma_tile.cuh is. Built by nvcc they
// are a block's threads; built by a host C++ compiler (the CPU test of this
// header) their thread loops become serial loops over the same indices, and
// step_host / res_host play the blocks one after another.
//
// The step program (every step form, and the window's streaming route).
// A task is a strip of W x-sites (W = 128 in f32 and bf16, 64 in f64) by a
// span of rows [y0, y1) of the block; a persistent grid walks the tasks. A
// block of W + 32 threads (a thread a site, and one more warp for the two
// edge columns) keeps a ring of four rows of post-collision values, W + 2
// sites wide (the strip and its edge columns), in shared memory (~18 KB in
// f32) and walks y:
//   * it collides row y + 1 once, each thread at most one site, loads
//     coalesced along x; a halo row (y = -1 or NY) comes from a strip, from
//     the block's other end, or from nowhere behind a wall
//     (cavity_site.cuh: collide_source_site);
//   * after one __syncthreads() it assembles row y from the ring's rows
//     y - 1, y and y + 1: the pull, the walls and the lid (pull_site), and
//     stores it, with its guarded macros in stored mode (store_site).
// The fourth slot lets the collide of row y + 1 overwrite row y - 3 while
// no thread reads it, so a row costs one barrier. Only the strip's edge
// columns and the rows y0 - 1 and y1 are collided twice (by the tasks
// beside it): 1.03-1.08x the sites, where a 32 x 8 tile with its halo
// collided 1.33x.
//
// The resident route of the window (K >= 2 steps in one launch, where the
// grid fits the co-resident blocks' shared memory). Block b owns a band of
// rows [b0, b0 + rows) and holds it in shared memory in the compute type
// for the whole window: 9 planes of rows x NX, plus two 3 x NX rows (the
// ghost rows' crossing directions). A step is two phases with a grid
// barrier between them:
//   A. res_collide: collide every site of the band in place (step 0 reads
//      and decodes f from device memory), and publish the band's first
//      row's directions 4, 7, 8 (cy = -1: the band below pulls them) and
//      its last row's 2, 5, 6 (cy = +1: the band above) to an exchange
//      buffer in device memory, two parities a step apart;
//   B. res_stream: read the neighbours' published rows (the bands wrap in
//      y: the block is periodic in y, walls where the caller names them),
//      then pull the band chunk by chunk: each thread computes the new
//      values of up to kHold sites of the chunk into registers, one
//      __syncthreads(), then writes them over the post values (the last
//      step encodes them straight to f_out). A chunk is whole rows; its
//      last row's directions 2, 5, 6, which the next chunk's first row
//      pulls, are kept in the lower ghost row before they are overwritten.
// The exchange of step k is read before any block reaches the barrier of
// step k + 1, so the parity written at step k + 2 is free again.
//
// Numbers: cavity_site.cuh's, unchanged; every route gives the plain
// version's result bit for bit.
#pragma once

#include <cstdint>

#include "cavity_site.cuh"
#include "tile_copy.cuh"

namespace {
namespace cavity {

// The strip width, a thread a site; the CPU test forces narrow strips.
#ifdef CAVITY_RUN
template <typename T>
constexpr int kRunC = CAVITY_RUN;
#else
template <typename T>
constexpr int kRunC = sizeof(T) == 8 ? 64 : 128;
#endif

// The resident route's block (1,024 threads in f32, 512 in f64, whose
// collision takes more registers) and the sites a thread holds across the
// write barrier (kHold x 9 registers); the CPU test forces small ones.
#ifdef CAVITY_RES_THREADS
template <typename T>
constexpr int kResThreads = CAVITY_RES_THREADS;
#else
template <typename T>
constexpr int kResThreads = sizeof(T) == 8 ? 512 : 1024;
#endif
#ifdef CAVITY_HOLD
template <typename T>
constexpr int kHold = CAVITY_HOLD;
#else
template <typename T>
constexpr int kHold = sizeof(T) == 8 ? 2 : 4;
#endif

template <typename T>
constexpr int kRingC = 4 * kQ * (kRunC<T> + 2);   // the ring's values

// ---- the step program ----

// What one step writes: f_out and, in stored mode, the macros.
template <typename In, typename Out, typename T, bool LEAN>
struct StepTask {
  StepIn<In, T> in;
  Out* f_out;
  T *rho_out, *ux_out, *uy_out;
};

// The tasks of a step: strips of W x-sites (the last ragged) by spans of
// rows (the last ragged), about one task for each of `resident` blocks
// (on a small grid a span is one row: the rows of a task collide one after
// another, so short spans keep a small launch's latency low).
struct StepPlan {
  int strips, span, spans, tasks;
};

template <typename T>
__host__ __device__ inline StepPlan step_plan(int NY, int NX, int64_t resident) {
  constexpr int W = kRunC<T>;
  StepPlan p;
  p.strips = (NX + W - 1) / W;
  if (resident < 1) resident = 1;
  const int64_t per = (static_cast<int64_t>(NY) * p.strips + resident - 1) / resident;
  p.span = static_cast<int>(per < NY ? per : NY);
  p.spans = (NY + p.span - 1) / p.span;
  p.tasks = p.strips * p.spans;
  return p;
}

// One task of one step: its strip and span, collided row by row into the
// ring (ring: kRingC<T> values of shared memory), each row of the span
// pulled and stored once its row above is collided.
template <typename In, typename Out, typename T, bool LEAN>
__device__ __forceinline__ void step_task(const StepTask<In, Out, T, LEAN>& a, const Geom& g,
                                          const StepPlan& p, int task, T tau, T u, T* ring) {
  constexpr int W = kRunC<T>, WP = W + 2, SLOT = kQ * WP;
  const int NX = g.NX;
  const int strip = task % p.strips, sp = task / p.strips;
  const int x0 = strip * W, w = NX - x0 < W ? NX - x0 : W;
  const int y0 = sp * p.span, y1 = y0 + p.span < g.NY ? y0 + p.span : g.NY;
  const int64_t plane = static_cast<int64_t>(g.NY) * NX;
  // row y's post-collision values at ring slot y & 3 (y = -1: slot 3);
  // column j holds x = x0 - 1 + j
  const auto collide_row = [&](int y) {
    T* r = ring + (y & 3) * SLOT;
    TILE_FOR(j, w + 2) {
      const int x = x0 - 1 + j;
      if (x < 0 || x >= NX) continue;
      T post[kQ];
      if (!collide_source_site<In, T, LEAN>(a.in, g, y, x, tau, post)) continue;
#pragma unroll
      for (int i = 0; i < kQ; ++i) r[i * WP + j] = post[i];
    }
  };
  // one call of collide_row, so the kernel holds one copy of the collision
  // (its static SASS counts are a site's work: the issue floor's model)
#pragma unroll 1
  for (int yc = y0 - 1; yc <= y1; ++yc) {
    collide_row(yc);
    const int y = yc - 1;
    if (y < y0) continue;
    TILE_SYNC();
    const T* rows[3] = {ring + ((y - 1) & 3) * SLOT, ring + (y & 3) * SLOT,
                        ring + ((y + 1) & 3) * SLOT};
    TILE_FOR(j, w) {
      T out[kQ];
      pull_site<T>(
          [&](int i, int dy, int dx) { return rows[dy + 1][i * WP + j + 1 + dx]; }, g, y,
          x0 + j, u, out);
      store_site<Out, T, LEAN>(out, a.f_out, a.rho_out, a.ux_out, a.uy_out, plane,
                               static_cast<int64_t>(y) * NX + x0 + j);
    }
  }
  TILE_SYNC();   // the next task's first rows overwrite the ring
}

// ---- the window's resident route ----

// The bands: `blocks` of them, the first `extra` holding rows_lo + 1 rows,
// the rest rows_lo; chunk: the rows a thread block pulls between two write
// barriers; smem: a block's shared memory in bytes. blocks == 0: the grid
// does not fit (the streaming route takes it).
struct ResPlan {
  int blocks, rows_lo, extra, chunk;
  int64_t smem;
};

// The plan of a window of K steps on NY x NX sites over at most max_blocks
// blocks of smem_limit bytes each, and at most 3 NY / 4 of them (the plan
// the route was measured with). The caller's exchange holds 2 parities x
// blocks x 6 rows.
template <typename T>
inline ResPlan res_plan(int NY, int NX, int K, int max_blocks, int64_t smem_limit) {
  ResPlan p{0, 0, 0, 0, 0};
  const int nb = max_blocks < 3 * NY / 4 ? max_blocks : 3 * NY / 4;
  const int chunk = kHold<T> * kResThreads<T> / NX;
  if (K < 2 || nb < 1 || chunk < 1) return p;
  const int rows_max = (NY + nb - 1) / nb;
  const int64_t smem = (static_cast<int64_t>(rows_max) * NX * kQ + 6 * NX) * sizeof(T);
  if (smem > smem_limit) return p;
  p.blocks = nb;
  p.rows_lo = NY / nb;
  p.extra = NY % nb;
  p.chunk = chunk;
  p.smem = smem;
  return p;
}

template <typename S, typename T>
struct ResArgs {
  const S* f;   // (9, NY, NX), read at step 0
  S* f_out;     // written at step K - 1
  T* exch;      // (2, blocks, 6, NX)
  Geom g;
  Window<T> w;
  ResPlan p;
};

struct Band {
  int b0, rows;
};

__host__ __device__ inline Band band_of(const ResPlan& p, int b) {
  return {b * p.rows_lo + (b < p.extra ? b : p.extra), p.rows_lo + (b < p.extra ? 1 : 0)};
}

// which of the three crossing directions a ghost row holds: 2, 5, 6 (the
// row below the band) or 4, 7, 8 (the row above)
__host__ __device__ constexpr int ghost_slot(int i) {
  return (i == 2 || i == 4) ? 0 : ((i == 5 || i == 7) ? 1 : 2);
}

// A value another block published: read past this SM's L1.
template <typename T>
__device__ __forceinline__ T load_published(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// Phase A of step k for block b: collide its band in place (step 0: from
// f), publish its edge rows. sm: the block's shared memory.
template <typename S, typename T>
__device__ __forceinline__ void res_collide(const ResArgs<S, T>& a, int b, int k, T* sm) {
  const Band bd = band_of(a.p, b);
  const int NX = a.g.NX, n = bd.rows * NX;
  T* ex = a.exch + static_cast<int64_t>((k & 1) * a.p.blocks + b) * 6 * NX;
  const StepIn<S, T> in{a.f, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  TILE_FOR(t, n) {
    T post[kQ];
    if (k == 0) {
      const int ly = t / NX;
      collide_source_site<S, T, true>(in, a.g, bd.b0 + ly, t - ly * NX, a.w.tau, post);
    } else {
      T fv[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) fv[i] = sm[i * n + t];
      collide_site<T, false>(fv, a.w.tau, post);
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) sm[i * n + t] = post[i];
    if (t < NX) {
      ex[t] = post[4];
      ex[NX + t] = post[7];
      ex[2 * NX + t] = post[8];
    }
    if (t >= n - NX) {
      const int x = t - (n - NX);
      ex[3 * NX + x] = post[2];
      ex[4 * NX + x] = post[5];
      ex[5 * NX + x] = post[6];
    }
  }
}

// Phase B of step k for block b, after the barrier: the neighbours' rows,
// then the pull chunk by chunk; lid speed u.
template <typename S, typename T>
__device__ __forceinline__ void res_stream(const ResArgs<S, T>& a, int b, int k, T* sm, T u) {
  constexpr int M = kHold<T>;
  const Band bd = band_of(a.p, b);
  const int NX = a.g.NX, rows = bd.rows, n = rows * NX, nb = a.p.blocks;
  T* lo = sm + kQ * n;   // the row below the chunk: directions 2, 5, 6
  T* hi = lo + 3 * NX;   // the row above the band: directions 4, 7, 8
  const T* ex = a.exch + static_cast<int64_t>((k & 1) * nb) * 6 * NX;
  const int64_t below = static_cast<int64_t>(b == 0 ? nb - 1 : b - 1) * 6 * NX;
  const int64_t above = static_cast<int64_t>(b == nb - 1 ? 0 : b + 1) * 6 * NX;
  TILE_FOR(t, 3 * NX) {
    lo[t] = load_published(ex + below + 3 * NX + t);
    hi[t] = load_published(ex + above + t);
  }
  TILE_SYNC();
  const bool last = k == a.w.K - 1;
  const int64_t plane = static_cast<int64_t>(a.g.NY) * NX;
  const int64_t base = static_cast<int64_t>(bd.b0) * NX;
#if defined(__CUDACC__)
  T hold_regs[M * kQ];
#define CAVITY_HOLD_OF(t) hold_regs
#else
  std::vector<T> hold_all(static_cast<size_t>(kResThreads<T>) * M * kQ);
#define CAVITY_HOLD_OF(t) (hold_all.data() + static_cast<size_t>(t) * M * kQ)
#endif
  for (int c0 = 0; c0 < rows; c0 += a.p.chunk) {
    const int c1 = c0 + a.p.chunk < rows ? c0 + a.p.chunk : rows;
    const int s1 = c1 * NX;
    TILE_FOR(t, kResThreads<T>) {
      T* h = CAVITY_HOLD_OF(t);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int s = c0 * NX + t + m * kResThreads<T>;
        if (s >= s1) continue;
        const int ly = s / NX, x = s - ly * NX;
        pull_site<T>(
            [&](int i, int dy, int dx) -> T {
              if (dy < 0)
                return ly == c0 ? lo[ghost_slot(i) * NX + x + dx] : sm[i * n + s - NX + dx];
              if (dy > 0)
                return ly == rows - 1 ? hi[ghost_slot(i) * NX + x + dx]
                                      : sm[i * n + s + NX + dx];
              return sm[i * n + s + dx];
            },
            a.g, bd.b0 + ly, x, u, h + m * kQ);
      }
    }
    TILE_SYNC();
    TILE_FOR(t, kResThreads<T>) {
      const T* h = CAVITY_HOLD_OF(t);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int s = c0 * NX + t + m * kResThreads<T>;
        if (s >= s1) continue;
        if (c1 < rows && s >= s1 - NX) {
          const int x = s - (s1 - NX);
          lo[x] = sm[2 * n + s];
          lo[NX + x] = sm[5 * n + s];
          lo[2 * NX + x] = sm[6 * n + s];
        }
        if (last) {
#pragma unroll
          for (int i = 0; i < kQ; ++i)
            Io<S, T>::store(a.f_out + i * plane + base + s, i, h[m * kQ + i]);
        } else {
#pragma unroll
          for (int i = 0; i < kQ; ++i) sm[i * n + s] = h[m * kQ + i];
        }
      }
    }
    TILE_SYNC();
  }
#undef CAVITY_HOLD_OF
}

#if !defined(__CUDACC__)
// The host build: one step's tasks one after another (last to first with
// `reverse`), through one ring.
template <typename In, typename Out, typename T, bool LEAN>
void step_host(const StepTask<In, Out, T, LEAN>& a, const Geom& g, const StepPlan& p, T tau, T u,
               bool reverse = false) {
  std::vector<T> ring(kRingC<T>);
  for (int k = 0; k < p.tasks; ++k)
    step_task(a, g, p, reverse ? p.tasks - 1 - k : k, tau, u, ring.data());
}

// The host build of the resident route: each block's shared memory kept
// across the window, the blocks' phases played in order (odd steps last to
// first) with the barrier between phase A and phase B.
template <typename S, typename T>
void res_host(const S* f, S* f_out, const Geom& g, const Window<T>& w, const ResPlan& p) {
  std::vector<std::vector<T>> sm(p.blocks, std::vector<T>(p.smem / sizeof(T)));
  std::vector<T> exch(static_cast<size_t>(2) * p.blocks * 6 * g.NX);
  const ResArgs<S, T> a{f, f_out, exch.data(), g, w, p};
  for (int k = 0; k < w.K; ++k) {
    for (int j = 0; j < p.blocks; ++j) {
      const int b = (k & 1) ? p.blocks - 1 - j : j;
      res_collide(a, b, k, sm[b].data());
    }
    for (int j = 0; j < p.blocks; ++j) {
      const int b = (k & 1) ? p.blocks - 1 - j : j;
      res_stream(a, b, k, sm[b].data(), lid_ramp(w, k));
    }
  }
}
#endif

}  // namespace cavity
}  // namespace

// The block program of the D3Q19 plasma column's collide + push-stream
// (csrc/fused_step3d.cu), written once for the card and for the host, as
// poisson_tile.cuh is. Built by nvcc it is a persistent block that walks
// over runs with a two-stage ring in shared memory; built by a host C++
// compiler (the CPU test of this header) its thread loops become serial
// loops over the same indices and tile3_host runs the runs one after
// another.
//
// Geometry. A shard of the (NZ, NY, NX) column (NX always whole) is
// extended by zh slices above and below it in z and by yh rows on either
// side in y (zh, yh in {0, 1}); the extra sites are its neighbours'
// pre-collision sites, which the caller exchanged as strips (the strip
// contract of lbm_tpu/kernels/fused_step3d.py:collide_stream_halo3d and
// fused_panel3d.py:collide_stream_panel3d, _zhalo):
//   * zh = 1, yh = 0 (a z-shard): the slice above (z0 - 1) and below
//     (z0 + NZ), pops (3, 19, NY, NX), fields (NY, NX); y wraps inside the
//     shard;
//   * zh = 0, yh = 1 (a y-shard): the row above (y0 - 1) and below
//     (y0 + NY), pops (3, 19, NZ, NX), fields (NZ, NX); z wraps inside;
//   * zh = 1, yh = 1 (a (dz, dy) tile): both, plus the four corner lines
//     (z0 - 1 or z0 + NZ, y0 - 1 or y0 + NY), pops (3, 19, NX), fields
//     (NX,). D3Q19 has (y, z) diagonals and no (x, y, z) ones, so these
//     lines are all a tile needs;
//   * zh = yh = 0: the periodic step of the whole column.
// x always wraps. Each strip is read in place through its own pointers and
// plane stride; the extended block is never formed.
//
// The tile. Every row (z, y) of the extended block is cut into runs of W
// x-sites, [x0, x0 + w), w = min(W, NX - x0); a row lies wholly in one
// source, so a run's source, plane stride and row offset are uniform. The
// block stages the run's 57 f, 57 g and Ex, Ey, Ez planes and its two
// x-neighbours (x0 - 1 and x0 + w, wrapped; for NX <= W they are sites of
// the run itself), collides all w + 2 sites, the neighbours again as their
// own runs do (so they match bitwise), and stores, for each (s, i), the w
// destination slots [x0, x0 + w) of row (z + cz, y + cy): one contiguous
// run, skipped whole when that row lies outside the shard (or wrapped on
// an axis without halo). Every output slot is written exactly once: slot
// (z, y, x, i) receives from (z - cz, y - cy, x - cx), which lies in the
// extended block. rho_q is written for the shard's own rows.
//
// The work of a run is spread over threads a (site, species) each: pass 1
// (moments3) sums that species' directions and writes its moments to
// shared memory; after a barrier, pass 2 (collide_species3) forms the two
// mixture velocity sets it needs from the staged moments and writes its 38
// values to an output tile in shared memory; after another barrier the
// block stores the tile, a contiguous run of each (s, i) plane. Pass 1 and pass 2
// read the staged planes, not L1 or L2: device memory is read once.
//
// Staging. Where every run and output row is 16-B aligned (tile3_aligned:
// NX * itemsize and W * itemsize multiples of 16, every pointer 16-B
// aligned), the run's 117 planes come by 1-D TMA copies that complete on
// the stage's mbarrier (lane 0 of each warp issues every 7th), and the
// output tile leaves by 16-B vector stores; elsewhere every thread copies
// elements with cp.async (bf16 planes, whose 2-B elements cp.async cannot
// move, through registers) and stores elements. The two neighbours' 234
// values travel through registers: loaded when the run's copies are
// issued, written to the stage after the previous run's passes, so that
// their latency hides behind the passes.
#pragma once

#include <cstdint>

#include "plasma3d_site.cuh"
#include "tile_copy.cuh"

namespace {

// The run width: 64 sites in f32 and bf16 storage, 32 in f64, so that a
// stage of any mode holds ~33 KB; the CPU test forces small runs.
#ifdef PLASMA3D_RUN
template <typename S>
constexpr int kRun3 = PLASMA3D_RUN;
#else
template <typename S>
constexpr int kRun3 = sizeof(S) == 8 ? 32 : 64;
#endif
// threads a block: a (site, species) task each, the run's 3 W in whole
// warps of one species, the x-neighbours' 6 in one more warp; in f32 and
// f64 one warp more, idle in the passes, for the copies and stores (at
// 256^3 f32 7% faster, bf16 11% slower: scripts/trace_plasma3d_torch.py's
// 224-threads variant)
template <typename S>
constexpr int kThreads3 = sizeof(S) == 2 ? 3 * kRun3<S> + 32 : 4 * kRun3<S>;
constexpr int kPlanes3 = 2 * kS * kQ3;     // 57 f and 57 g planes
constexpr int kStaged3 = kPlanes3 + 3;     // and Ex, Ey, Ez
constexpr int kNbVals3 = 2 * kStaged3;     // the two x-neighbours' values

// One source of sites: populations f, g and the fields Ex, Ey, Ez.
template <typename S, typename T>
struct Src3 {
  const S *f, *g;
  const T *ex, *ey, *ez;
};

struct Geom3 {
  int NZ, NY, NX;   // the shard
  int zh, yh;       // halo depth in z and in y: 0 (the axis wraps) or 1
};

// The launch: the shard and its strips in the C entry's pointer order
// (shard; slices z0 - 1, z0 + NZ; rows y0 - 1, y0 + NY; corner lines
// (z0 - 1, y0 - 1), (z0 - 1, y0 + NY), (z0 + NZ, y0 - 1), (z0 + NZ,
// y0 + NY)), the outputs, the geometry and the staging route.
template <typename S, typename T>
struct Tile3Args {
  Src3<S, T> src[9];
  S* f_out;
  S* g_out;
  T* rho_q;
  Geom3 gm;
  int aligned;   // TMA bulk copies and 16-B vector stores (tile3_aligned)
};

// The shared-memory layout of a block: two stages, the output tile, the
// staged moments, the run's destination rows, the parameters and the
// stages' mbarriers. A staged plane holds the left neighbour at kLead - 1,
// the run at [kLead, kLead + w) (16-B aligned) and the right neighbour at
// kLead + w.
template <typename S, typename T>
struct Tile3Smem {
  static constexpr int W = kRun3<S>;
  static constexpr int kLeadS = 16 / sizeof(S), kLeadT = 16 / sizeof(T);
  static constexpr int kPitchS = W + 2 * kLeadS, kPitchT = W + 2 * kLeadT;
  static constexpr int kSites = W + 2;
  static constexpr size_t kStagePops = round16(kPlanes3 * kPitchS * sizeof(S));
  static constexpr size_t kStage = round16(kStagePops + 3 * kPitchT * sizeof(T));
  static constexpr size_t kOut = 2 * kStage;
  // moments: r, ux, uy, uz, temp of each species, then the neutral's delta
  static constexpr int kMacs = 5 * kS + 1;
  static constexpr size_t kMac = kOut + round16(kPlanes3 * W * sizeof(S));
  static constexpr size_t kRows = kMac + round16(kMacs * kSites * sizeof(T));
  static constexpr size_t kParams = kRows + round16(kQ3 * sizeof(int64_t));
  static constexpr size_t kBars = kParams + round16(sizeof(Params<T>));
  static constexpr size_t kBytes = kBars + 16;
};

// the neighbour values a thread carries from a run's issue to its staging
#if defined(__CUDACC__)
template <typename S>
constexpr int kNbSlots3 = (kNbVals3 + kThreads3<S> - 1) / kThreads3<S>;
#define T3_SLOTS(k, e, n)                                                           \
  for (int k = 0, e = static_cast<int>(threadIdx.x); k < kNbSlots3<S>;          \
       ++k, e += static_cast<int>(blockDim.x))                                    \
    if (e < (n))
#else
template <typename S>
constexpr int kNbSlots3 = kNbVals3;
#define T3_SLOTS(k, e, n) for (int k = 0, e = 0; e < (n); ++k, ++e)
#endif

template <typename S, typename T>
struct Nb3 {
  S pop[kNbSlots3<S>];
  T fld[kNbSlots3<S>];
};

// One run: its source, the source's plane stride and the row's offset in
// it, the row in shard coordinates, and the run's sites.
template <typename S, typename T>
struct Run3 {
  Src3<S, T> src;
  int64_t vol, roff;
  int z, y, x0, w;
  bool own;   // the row lies in the shard: rho_q is written
};

// (run indices are 32-bit: the C entry refuses 2^30 runs, 2^36 sites)
template <typename S>
__host__ __device__ inline int64_t tile3_runs(const Geom3& gm) {
  constexpr int W = kRun3<S>;
  return static_cast<int64_t>(gm.NZ + 2 * gm.zh) * (gm.NY + 2 * gm.yh) *
         ((gm.NX + W - 1) / W);
}

// Whether the launch may stage with TMA bulk copies and store with 16-B
// vectors: every run's planes and every output row start 16-B aligned and
// hold a multiple of 16 B.
template <typename S, typename T>
__host__ __device__ inline int tile3_aligned(const Tile3Args<S, T>& a) {
  constexpr int W = kRun3<S>;
  const int64_t NX = a.gm.NX;
  if ((W * sizeof(S)) % 16 || (W * sizeof(T)) % 16 || (NX * sizeof(S)) % 16 ||
      (NX * sizeof(T)) % 16)
    return 0;
  const auto off = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16; };
  for (int k = 0; k < 9; ++k) {
    const Src3<S, T>& s = a.src[k];
    if (off(s.f) || off(s.g) || off(s.ex) || off(s.ey) || off(s.ez)) return 0;
  }
  return off(a.f_out) || off(a.g_out) ? 0 : 1;
}

template <typename S, typename T>
__device__ __forceinline__ Run3<S, T> run3_of(const Tile3Args<S, T>& a, int r) {
  constexpr int W = kRun3<S>;
  const Geom3& gm = a.gm;
  const int NZ = gm.NZ, NY = gm.NY, NX = gm.NX;
  const int nxr = (NX + W - 1) / W;
  const int row = r / nxr;
  const int eNY = NY + 2 * gm.yh;
  const int ze = row / eNY;
  Run3<S, T> u;
  u.x0 = (r - row * nxr) * W;
  u.w = NX - u.x0 < W ? NX - u.x0 : W;
  u.z = ze - gm.zh;
  u.y = row - ze * eNY - gm.yh;
  const bool zin = u.z >= 0 && u.z < NZ;
  const bool yin = u.y >= 0 && u.y < NY;
  u.own = zin && yin;
  if (zin && yin) {
    u.src = a.src[0];
    u.vol = static_cast<int64_t>(NZ) * NY * NX;
    u.roff = (static_cast<int64_t>(u.z) * NY + u.y) * NX;
  } else if (yin) {
    u.src = a.src[u.z < 0 ? 1 : 2];
    u.vol = static_cast<int64_t>(NY) * NX;
    u.roff = static_cast<int64_t>(u.y) * NX;
  } else if (zin) {
    u.src = a.src[u.y < 0 ? 3 : 4];
    u.vol = static_cast<int64_t>(NZ) * NX;
    u.roff = static_cast<int64_t>(u.z) * NX;
  } else {
    u.src = a.src[u.z < 0 ? (u.y < 0 ? 5 : 6) : (u.y < 0 ? 7 : 8)];
    u.vol = NX;
    u.roff = 0;
  }
  return u;
}

// staged plane q of a run in the source: f (q < 57), g, then Ex, Ey, Ez
template <typename S, typename T>
__device__ __forceinline__ const S* pop_src3(const Run3<S, T>& u, int q) {
  return (q < kS * kQ3 ? u.src.f + static_cast<int64_t>(q) * u.vol
                       : u.src.g + static_cast<int64_t>(q - kS * kQ3) * u.vol) +
         u.roff;
}
template <typename S, typename T>
__device__ __forceinline__ const T* fld_src3(const Run3<S, T>& u, int k) {
  return (k == 0 ? u.src.ex : (k == 1 ? u.src.ey : u.src.ez)) + u.roff;
}

// the row offset in the shard of (z + cz_i, y + cy_i), -1 outside it
__device__ __forceinline__ int64_t dest_row3(const Geom3& gm, int z, int y, int i) {
  int zd = z + cz3_of(i), yd = y + cy3_of(i);
  if (gm.zh) {
    if (zd < 0 || zd >= gm.NZ) return -1;
  } else {
    zd = zd < 0 ? gm.NZ - 1 : (zd >= gm.NZ ? 0 : zd);
  }
  if (gm.yh) {
    if (yd < 0 || yd >= gm.NY) return -1;
  } else {
    yd = yd < 0 ? gm.NY - 1 : (yd >= gm.NY ? 0 : yd);
  }
  return (static_cast<int64_t>(zd) * gm.NY + yd) * gm.NX;
}

// ---- the block program ----

// Issue the copies of run u into stage `st`: its planes by TMA (aligned) or
// by elements, one cp.async group; its neighbours' values into nb.
template <typename S, typename T>
__device__ __forceinline__ void tile3_issue(const Tile3Args<S, T>& a, const Run3<S, T>& u,
                                            unsigned char* st, uint64_t* bar, Nb3<S, T>& nb) {
  using L = Tile3Smem<S, T>;
  S* pops = reinterpret_cast<S*>(st) + L::kLeadS;
  T* flds = reinterpret_cast<T*>(st + L::kStagePops) + L::kLeadT;
  const int w = u.w, NX = a.gm.NX;
  if (a.aligned) {
    // thread 0: the one arrival, with every copy's bytes
    const uint32_t bytes = static_cast<uint32_t>(w) * (kPlanes3 * sizeof(S) + 3 * sizeof(T));
#if defined(__CUDA_ARCH__)
    if (threadIdx.x == 0)
#endif
      bar_expect(bar, bytes);
    per_warp(kStaged3, [&](int q) {
      if (q < kPlanes3)
        bulk_copy(pops + q * L::kPitchS, pop_src3(u, q) + u.x0, w * sizeof(S), bar);
      else
        bulk_copy(flds + (q - kPlanes3) * L::kPitchT, fld_src3(u, q - kPlanes3) + u.x0,
                   w * sizeof(T), bar);
    });
  } else {
    TILE_FOR(t, kStaged3 * L::W) {
      const int q = t / L::W, e = t - q * L::W;
      if (e >= w) continue;
      if (q < kPlanes3)
        elem_copy(pops + q * L::kPitchS + e, pop_src3(u, q) + u.x0 + e);
      else
        elem_copy(flds + (q - kPlanes3) * L::kPitchT + e, fld_src3(u, q - kPlanes3) + u.x0 + e);
    }
  }
  async_commit();
  T3_SLOTS(k, e, kNbVals3) {
    const int side = e / kStaged3, q = e - side * kStaged3;
    const int x = side ? (u.x0 + w == NX ? 0 : u.x0 + w) : (u.x0 == 0 ? NX - 1 : u.x0 - 1);
    if (q < kPlanes3)
      nb.pop[k] = pop_src3(u, q)[x];
    else
      nb.fld[k] = fld_src3(u, q - kPlanes3)[x];
  }
}

// Write the neighbours' values of run u into stage `st`.
template <typename S, typename T>
__device__ __forceinline__ void tile3_put_nb(const Run3<S, T>& u, unsigned char* st,
                                             const Nb3<S, T>& nb) {
  using L = Tile3Smem<S, T>;
  S* pops = reinterpret_cast<S*>(st) + L::kLeadS;
  T* flds = reinterpret_cast<T*>(st + L::kStagePops) + L::kLeadT;
  T3_SLOTS(k, e, kNbVals3) {
    const int side = e / kStaged3, q = e - side * kStaged3;
    const int at = side ? u.w : -1;
    if (q < kPlanes3)
      pops[q * L::kPitchS + at] = nb.pop[k];
    else
      flds[(q - kPlanes3) * L::kPitchT + at] = nb.fld[k];
  }
}

// task t of a run of w sites: species s at staged site j (0: the left
// neighbour, 1..w: the run, w + 1: the right neighbour); the run's tasks
// come species by species, W / 32 warps each, the neighbours' six last, in
// one warp, where each collides only the 5 directions that land in the run
template <int W>
__device__ __forceinline__ bool task3(int t, int w, int& s, int& j) {
  if (t < kS * W) {
    s = t / W;
    j = 1 + (t - s * W);
    return j <= w;
  }
  const int k = t - kS * W;
  s = k >> 1;
  j = (k & 1) ? w + 1 : 0;
  return true;
}

// The passes and the store of run u, staged in stage `st`; `sm` is the
// block's shared memory (the output tile, the moments).
template <typename S, typename T, bool DELTA, bool FAST>
__device__ __forceinline__ void tile3_run(const Tile3Args<S, T>& a, const Run3<S, T>& u,
                                          const unsigned char* st, unsigned char* sm,
                                          const Params<T>& p) {
  using L = Tile3Smem<S, T>;
  constexpr int W = L::W, kSites = L::kSites, kTasks = kS * W + 2 * kS;
  const S* pops = reinterpret_cast<const S*>(st) + L::kLeadS - 1;
  const T* flds = reinterpret_cast<const T*>(st + L::kStagePops) + L::kLeadT - 1;
  S* out = reinterpret_cast<S*>(sm + L::kOut);
  T* mac = reinterpret_cast<T*>(sm + L::kMac);
  const int w = u.w;

  // pass 1: a species' moments at a site
  TILE_FOR(t, kTasks) {
    int s, j;
    if (!task3<W>(t, w, s, j)) continue;
    const Moments3<T> m = moments3<S, T, DELTA>(
        s, pops + (s * kQ3) * L::kPitchS + j, pops + ((kS + s) * kQ3) * L::kPitchS + j,
        L::kPitchS, flds[j], flds[L::kPitchT + j], flds[2 * L::kPitchT + j], p);
    mac[(0 * kS + s) * kSites + j] = m.r;
    mac[(1 * kS + s) * kSites + j] = m.ux;
    mac[(2 * kS + s) * kSites + j] = m.uy;
    mac[(3 * kS + s) * kSites + j] = m.uz;
    mac[(4 * kS + s) * kSites + j] = m.temp;
    if (DELTA && s == 2) mac[5 * kS * kSites + j] = m.d;
  }
  TILE_SYNC();

  // pass 2: a species' collision at a site, into the output tile; and the
  // run's destination row of each direction
  int64_t* drow = reinterpret_cast<int64_t*>(sm + L::kRows);
  TILE_FOR(i, kQ3) drow[i] = dest_row3(a.gm, u.z, u.y, i);
  TILE_FOR(t, kTasks) {
    int s, j;
    if (!task3<W>(t, w, s, j)) continue;
    T r[kS], ux[kS], uy[kS], uz[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      r[k] = mac[(0 * kS + k) * kSites + j];
      ux[k] = mac[(1 * kS + k) * kSites + j];
      uy[k] = mac[(2 * kS + k) * kSites + j];
      uz[k] = mac[(3 * kS + k) * kSites + j];
    }
    const T ts = mac[(4 * kS + s) * kSites + j];
    const T drho_n = DELTA ? mac[5 * kS * kSites + j] : T(0);
    collide_species3<S, T, DELTA, FAST>(
        s, r, ux, uy, uz, ts, drho_n, flds[j], flds[L::kPitchT + j], flds[2 * L::kPitchT + j],
        pops + (s * kQ3) * L::kPitchS + j, pops + ((kS + s) * kQ3) * L::kPitchS + j,
        L::kPitchS, p,
        // direction i lands on slot x + cx of its destination row: in the
        // run, or (the neighbours' other directions) skipped
        [&](int i) { return j - 1 + cx3_of(i) >= 0 && j - 1 + cx3_of(i) < w; },
        [&](int i, T fo, T go) {
          const int o = j - 1 + cx3_of(i);
          Io<S, T>::store(out + (s * kQ3 + i) * W + o, fo);
          Io<S, T>::store(out + ((kS + s) * kQ3 + i) * W + o, go);
        });
    if (s == 0 && u.own && j >= 1 && j <= w)
      a.rho_q[u.roff + u.x0 + j - 1] = rho_q3(r[0], r[1], p);
  }
  TILE_SYNC();

  // the store: each (s, i) run of the tile to its destination row
  const int64_t ovol = static_cast<int64_t>(a.gm.NZ) * a.gm.NY * a.gm.NX;
  if (a.aligned) {
    constexpr int kV = 16 / sizeof(S), kNV = W / kV;
    const int nv = w / kV;
    TILE_FOR(t, kPlanes3 * kNV) {
      const int q = t / kNV, v = t - q * kNV;
      const int sq = q < kS * kQ3 ? q : q - kS * kQ3;
      const int64_t row = drow[sq % kQ3];
      if (v >= nv || row < 0) continue;
      S* dst = (q < kS * kQ3 ? a.f_out : a.g_out) + sq * ovol + row + u.x0 + v * kV;
      copy16(dst, out + q * W + v * kV);
    }
  } else {
    TILE_FOR(t, kPlanes3 * W) {
      const int q = t / W, e = t - q * W;
      const int sq = q < kS * kQ3 ? q : q - kS * kQ3;
      const int64_t row = drow[sq % kQ3];
      if (e >= w || row < 0) continue;
      (q < kS * kQ3 ? a.f_out : a.g_out)[sq * ovol + row + u.x0 + e] = out[q * W + e];
    }
  }
}

#if defined(__CUDACC__)
// The persistent block: runs blockIdx.x, + gridDim.x, ...; run k is staged
// in stage k & 1 while run k - 1 computes.
template <typename S, typename T, bool DELTA, bool FAST>
__device__ __forceinline__ void tile3_block(const Tile3Args<S, T>& a, const Params<T>& pc) {
  using L = Tile3Smem<S, T>;
  extern __shared__ __align__(128) unsigned char sm[];
  Params<T>& p = *reinterpret_cast<Params<T>*>(sm + L::kParams);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  const int runs = static_cast<int>(tile3_runs<S>(a.gm));
  int r = static_cast<int>(blockIdx.x);
  if (r >= runs) return;
  if (threadIdx.x == 0) {
    p = pc;
    bar_init(bar);
    bar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Nb3<S, T> nb;
  Run3<S, T> u = run3_of(a, r);
  tile3_issue(a, u, sm, bar, nb);
  tile3_put_nb(u, sm, nb);
  for (int k = 0;; ++k) {
    const int rn = r + static_cast<int>(gridDim.x);
    unsigned char* next = sm + ((k + 1) & 1) * L::kStage;
    Run3<S, T> un;
    if (rn < runs) {
      un = run3_of(a, rn);
      tile3_issue(a, un, next, bar + ((k + 1) & 1), nb);
    } else {
      async_commit();   // an empty group: wait_group 1 then covers run k
    }
    if (a.aligned) bar_wait(bar + (k & 1), (k >> 1) & 1);
    async_wait_prev();
    __syncthreads();
    tile3_run<S, T, DELTA, FAST>(a, u, sm + (k & 1) * L::kStage, sm, p);
    if (rn >= runs) break;
    tile3_put_nb(un, next, nb);
    r = rn;
    u = un;
  }
}
#else
// The host build: the runs one after another, alternating stages.
template <typename S, typename T, bool DELTA, bool FAST>
void tile3_host(const Tile3Args<S, T>& a, const HostParams& hp) {
  using L = Tile3Smem<S, T>;
  std::vector<uint64_t> buf(L::kBytes / 8 + 1);
  unsigned char* sm = reinterpret_cast<unsigned char*>(buf.data());
  const Params<T> p = cast_params<T>(hp);
  Nb3<S, T> nb;
  for (int r = 0; r < tile3_runs<S>(a.gm); ++r) {
    unsigned char* st = sm + (r & 1) * L::kStage;
    const Run3<S, T> u = run3_of(a, r);
    tile3_issue(a, u, st, nullptr, nb);
    tile3_put_nb(u, st, nb);
    tile3_run<S, T, DELTA, FAST>(a, u, st, sm, p);
  }
}
#endif

}  // namespace

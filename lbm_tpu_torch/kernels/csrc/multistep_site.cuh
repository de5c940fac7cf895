// The wall rules of the K-step window kernel (fused_multistep.cu): where a
// post-collision value goes when it is push-streamed on a band that is
// periodic in y, with or without bounce-back walls. The tile program
// (plasma_tile.cuh) applies them.
//
// A window steps a band of NY x NX sites (Band). Without walls it is
// periodic in both axes. With walls, the x walls at x = 0 and x = NX - 1
// apply on every row, and the y walls only on the rows b (bottom) and t
// (top) that the band holds (-1: none); elsewhere the push wraps in y
// within the band. The whole grid is the band (0, NY - 1)
// (lbm_tpu/kernels/fused_multistep.collide_stream_multistep, bounce=True),
// and a shard extended by K ghost rows a side is a band with its global
// walls at rows K and K + rows - 1 where it holds them, (-1, -1) where it
// holds neither (collide_stream_multistep_gated).
//
// Which slots a post-collision value P_i(y, x) fills is
// lbm_tpu/ops/stream.bounceback_fix_dirs_gated read from the source's side.
// That function writes the periodic push, then the x-wall columns and the
// y-wall rows in an order that encodes the reference's serial corner
// winners (src/streaming.cpp:70-105). Every value it moves lands in one of
// four slots: the periodic destination (i, y + cy, x + cx), or the
// opposite direction's slot at the site, beside it in x or beside it in y.
// pushes(i, s) says which of those four the value takes, from where the
// walls meet the site (Site); every slot is written by one thread. A push
// from beyond a wall row into it is suppressed: the wall row's reflections
// fill those slots with same-row values, and so keep the band's ghost rows
// out of it. The 8 corner holes keep their own stale value. Sites away
// from the walls push periodically.
//
// The stale values are the site's own pre-collision f for the f pass and
// its post-collision f for the g pass, plus neutral_ref * w_i for species 2
// under delta storage (lbm_tpu/kernels/fused_multistep.py:309-337).
//
// The functions are __device__ for the kernel; with host stand-ins for
// cuda_bf16.h and cuda_runtime.h they build with the host's C++ compiler,
// and the CPU tests hold a window of the tile program bitwise against its
// plain version (tests/test_torch_kernel_host.py).
#pragma once

#include <cstdint>

#include "plasma_site.cuh"

namespace {
namespace window {

struct Band {
  int NY, NX;
  int walls;   // 0: periodic in both axes; 1: bounce-back walls
  int b, t;    // the bottom and top wall rows of a walled band (-1: none)
};

__host__ __device__ __forceinline__ int wrap_y(int y, int NY) {
  return y < 0 ? y + NY : (y >= NY ? y - NY : y);
}

// Where the walls of a walled band meet site (y, x).
struct Site {
  bool xl, xr, xin;   // x = 0; x = NX - 1; x <= NX - 3
  bool yb, yt;        // the row is the bottom, the top wall row
  bool upb, upt;      // the row above (y + 1, wrapped) is the bottom, top wall row
  bool dnb, dnt;      // the row below (y - 1, wrapped)
};

__host__ __device__ __forceinline__ Site site_of(int y, int x, const Band& g) {
  const int up = wrap_y(y + 1, g.NY), dn = wrap_y(y - 1, g.NY);
  return {x == 0,  x == g.NX - 1, x <= g.NX - 3, y == g.b,  y == g.t,
          up == g.b, up == g.t,   dn == g.b,     dn == g.t};
}

// The site lies where the periodic push is not the whole story: a wall
// column, a wall row, or a row from which pushes enter a wall row.
__host__ __device__ __forceinline__ bool near_wall(const Site& s) {
  return s.xl || s.xr || s.yb || s.yt || s.upb || s.dnt;
}

// Where P_i(y, x) of a walled band goes: bit c for candidate c (0: the
// periodic slot (i, y + cy, x + cx); 1, 2, 3: slot opp(i) at (y, x),
// (y, x + cx), (y + cy, x)), and bit 4 when slot (i, y, x) keeps its
// stale value (a corner hole).
__host__ __device__ __forceinline__ unsigned pushes(int i, const Site& s) {
  const int cx = cx_of(i), cy = cy_of(i);
  // the periodic push, unless it crosses the x walls or enters a wall row
  // from beyond it
  const bool pass = !(cx == 1 && s.xr) && !(cx == -1 && s.xl) && !(cy == 1 && s.upb) && !(cy == -1 && s.dnt);
  unsigned m = pass ? 1u : 0u;
  const auto bit = [](bool on, unsigned b) { return on ? b : 0u; };
  switch (i) {
    case 1:   // the x walls reflect in place, on every row
      return m | bit(s.xr, 2u);
    case 3:
      return m | bit(s.xl, 2u);
    case 2:   // the y walls, on their rows
      return m | bit(s.yt, 2u);
    case 4:
      return m | bit(s.yb, 2u);
    case 5:   // -> 7: the top row from x - 1 (its last slot in place), the
              // right column from y - 1; hole (5, b, NX-1), (5, t, 0)
      return m | bit(s.yt && s.xr, 2u) | bit(s.yt && s.xin, 4u) |
             bit(s.xr && !s.upt && !s.upb, 8u) |
             bit((s.yb && s.xr) || (!s.yb && s.xl && s.yt), 16u);
    case 6:   // -> 8: the top row from x + 1, the left column from y - 1;
              // hole (6, b, 0), (6, t, NX-1); the column wins (6, b, NX-1)
      return m | bit(s.yt && !s.xl, 4u) | bit(s.xl && !s.upt && !s.upb, 8u) |
             bit((s.xr && s.yt) || (!s.xr && s.yb && s.xl), 16u);
    case 7:   // -> 5: the bottom row from x + 1, the left column from y + 1;
              // hole (7, b, NX-1), (7, t, 0); the row wins (5, b, 0)
      return m | bit(s.yb && !s.xl, 4u) | bit(s.xl && !s.dnb && !s.dnt, 8u) |
             bit((s.yt && s.xl) || (!s.yt && s.xr && s.yb), 16u);
    case 8:   // -> 6: the bottom row from x - 1, the right column from y + 1;
              // hole (8, b, 0), (8, t, NX-1)
      return m | bit(s.yb && s.xin, 4u) | bit(s.xr && !s.dnt, 8u) |
             bit((s.yt && s.xr) || (!s.yt && s.xl && s.yb), 16u);
    default:
      return m;
  }
}

}  // namespace window
}  // namespace

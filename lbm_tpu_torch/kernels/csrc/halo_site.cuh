// The per-site work of the halo collide + push-stream (fused_step.cu's halo
// mode): one thread, one site of a shard's EXTENDED block.
//
// A shard of the lattice (a y-shard of full width, or a (y, x) tile) is
// extended by one row above and below it and, on a tile, by one column left
// and right of it. The extra sites are the neighbours' pre-collision sites,
// which the caller exchanged as strips (the strip contract of
// lbm_tpu/kernels/fused_step.py:collide_stream_halo and _halo2d):
//   * the row above is the LAST row of the up strip, the row below the
//     FIRST row of the dn strip; on a tile both are corner-extended by
//     `ext` columns a side (strip width NX + 2 ext), so column ext - 1 and
//     column ext + NX are the diagonal neighbours' corner sites;
//   * on a tile, the column left is the LAST column of the lt strip and the
//     column right the FIRST column of the rt strip;
//   * a y-shard has no x strips: x wraps around the shard's own width.
// Strips may be any depth >= 1; only the edge row or column is read.
//
// Every site of the extended block collides its own 27 f and 27 g with
// plasma_site.cuh's collide_site (so the arithmetic is the periodic
// kernel's, and the result is bitwise equal to collide_stream on the full
// grid at every shard site) and pushes each value to (y + cy, x + cx) when
// that lies inside the shard. Every output slot is written exactly once:
// slot (y, x, i) receives from (y - cy, x - cx), which lies in the extended
// block. rho_q is written for the shard's own sites only.
#pragma once

#include "plasma_site.cuh"

namespace {

// The shard's inputs: populations (3, 9, NY, NX) and fields (NY, NX); the
// y strips (3, 9, du, NX + 2 ext) and (du, NX + 2 ext) (dd rows below); on
// a tile the x strips (3, 9, NY, dl) and (NY, dl) (dr columns right).
template <typename S, typename T>
struct HaloIn {
  const S *f, *g;
  const T *ex, *ey;
  const S *f_up, *g_up;
  const T *ex_up, *ey_up;
  const S *f_dn, *g_dn;
  const T *ex_dn, *ey_dn;
  const S *f_lt, *g_lt;
  const T *ex_lt, *ey_lt;
  const S *f_rt, *g_rt;
  const T *ex_rt, *ey_rt;
};

// ext == 0: a y-shard (x wraps); ext >= 1: a tile with x strips.
struct HaloGeom {
  int NY, NX;
  int du, dd;
  int ext;
  int dl, dr;
};

__host__ __device__ inline int64_t halo_sites(const HaloGeom& gm) {
  return static_cast<int64_t>(gm.NY + 2) * (gm.ext > 0 ? gm.NX + 2 : gm.NX);
}

template <typename S, typename T, bool DELTA, bool FAST>
__device__ __forceinline__ void collide_stream_halo_site(const HaloIn<S, T>& in, S* f_out,
                                                         S* g_out, T* rho_q,
                                                         const HaloGeom& gm, int64_t esite,
                                                         const Params<T>& p) {
  const bool tile = gm.ext > 0;
  const int NY = gm.NY, NX = gm.NX;
  const int we = tile ? NX + 2 : NX;
  const int ye = static_cast<int>(esite / we);
  const int xe = static_cast<int>(esite - static_cast<int64_t>(ye) * we);
  // the source site in shard coordinates: y in [-1, NY], x in [-1, NX]
  const int y = ye - 1;
  const int x = tile ? xe - 1 : xe;

  const S *fs, *gs;
  const T *exs, *eys;
  int64_t plane, off;
  if (y < 0) {
    const int w = NX + 2 * gm.ext;
    fs = in.f_up, gs = in.g_up, exs = in.ex_up, eys = in.ey_up;
    plane = static_cast<int64_t>(gm.du) * w;
    off = static_cast<int64_t>(gm.du - 1) * w + (x + gm.ext);
  } else if (y >= NY) {
    const int w = NX + 2 * gm.ext;
    fs = in.f_dn, gs = in.g_dn, exs = in.ex_dn, eys = in.ey_dn;
    plane = static_cast<int64_t>(gm.dd) * w;
    off = x + gm.ext;
  } else if (x < 0) {
    fs = in.f_lt, gs = in.g_lt, exs = in.ex_lt, eys = in.ey_lt;
    plane = static_cast<int64_t>(NY) * gm.dl;
    off = static_cast<int64_t>(y) * gm.dl + (gm.dl - 1);
  } else if (x >= NX) {
    fs = in.f_rt, gs = in.g_rt, exs = in.ex_rt, eys = in.ey_rt;
    plane = static_cast<int64_t>(NY) * gm.dr;
    off = static_cast<int64_t>(y) * gm.dr;
  } else {
    fs = in.f, gs = in.g, exs = in.ex, eys = in.ey;
    plane = static_cast<int64_t>(NY) * NX;
    off = static_cast<int64_t>(y) * NX + x;
  }

  T fv[kS][kQ], gv[kS][kQ];
  load_site<S, T>(fs, gs, plane, off, fv, gv);
  const int64_t out_plane = static_cast<int64_t>(NY) * NX;
  const T rq = collide_site<T, DELTA, FAST>(
      fv, gv, exs[off], eys[off], p, [&](int s, const T* fo, const T* go) {
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const int yd = y + cy_of(i);
          int xd = x + cx_of(i);
          if (yd < 0 || yd >= NY) continue;
          if (tile) {
            if (xd < 0 || xd >= NX) continue;
          } else {
            xd = xd < 0 ? NX - 1 : (xd >= NX ? 0 : xd);
          }
          const int64_t dst = (s * kQ + i) * out_plane + static_cast<int64_t>(yd) * NX + xd;
          Io<S, T>::store(f_out + dst, fo[i]);
          Io<S, T>::store(g_out + dst, go[i]);
        }
      });
  if (y >= 0 && y < NY && x >= 0 && x < NX) rho_q[static_cast<int64_t>(y) * NX + x] = rq;
}

}  // namespace

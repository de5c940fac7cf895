// The per-site work of the 3-D halo collide + push-stream (fused_step3d.cu's
// halo entry): one thread, one site of a shard's EXTENDED block.
//
// A shard of the (NZ, NY, NX) column (NX always whole) is extended by zh
// slices above and below it in z and by yh rows on either side of it in y
// (zh, yh in {0, 1}). The extra sites are the neighbours' pre-collision
// sites, which the caller exchanged as strips (the strip contract of
// lbm_tpu/kernels/fused_step3d.py:collide_stream_halo3d and
// fused_panel3d.py:collide_stream_panel3d, _zhalo):
//   * zh = 1, yh = 0 (a z-shard): the slice above (z0 - 1) and below
//     (z0 + NZ), pops (3, 19, NY, NX), fields (NY, NX); y wraps inside the
//     shard;
//   * zh = 0, yh = 1 (a y-shard): the row above (y0 - 1) and below
//     (y0 + NY), pops (3, 19, NZ, NX), fields (NZ, NX); z wraps inside the
//     shard;
//   * zh = 1, yh = 1 (a (dz, dy) tile): both, plus the four corner lines
//     (z0 - 1 or z0 + NZ, y0 - 1 or y0 + NY), pops (3, 19, NX), fields
//     (NX,). "Above" is the row y0 - 1, "below" y0 + NY, inside the slice
//     above (z0 - 1: corners_up) or below (corners_dn). D3Q19 has (y, z)
//     diagonals and no (x, y, z) ones, so these lines are all a tile needs.
// x always wraps. Each strip is read in place through its own pointers and
// plane stride; the extended block is never formed.
//
// Every site of the extended block collides its own 57 f and 57 g with
// plasma3d_site.cuh's collide_site3d (the periodic kernel's arithmetic, so
// a halo site recollides bitwise as its owner does) and pushes each value
// to (x + cx mod NX, y + cy, z + cz) when that lies inside the shard. Every
// output slot is written exactly once: slot (z, y, x, i) receives from
// (z - cz, y - cy, x - cx), which lies in the extended block. rho_q is
// written for the shard's own sites only.
#pragma once

#include "plasma3d_site.cuh"

namespace {

// One source of sites: populations f, g and the fields Ex, Ey, Ez.
template <typename S, typename T>
struct Src3 {
  const S *f, *g;
  const T *ex, *ey, *ez;
};

// The shard and its strips, in the C entry's pointer order.
template <typename S, typename T>
struct Halo3In {
  Src3<S, T> shard;
  Src3<S, T> slice_up, slice_dn;    // zh: the slices z0 - 1 and z0 + NZ
  Src3<S, T> row_up, row_dn;        // yh: the rows y0 - 1 and y0 + NY
  Src3<S, T> up_above, up_below;    // zh and yh: corner lines at z0 - 1
  Src3<S, T> dn_above, dn_below;    // and at z0 + NZ
};

struct Halo3Geom {
  int NZ, NY, NX;   // the shard
  int zh, yh;       // halo depth in z and in y: 0 (the axis wraps) or 1
};

__host__ __device__ inline int64_t halo3d_sites(const Halo3Geom& gm) {
  return static_cast<int64_t>(gm.NZ + 2 * gm.zh) * (gm.NY + 2 * gm.yh) * gm.NX;
}

template <typename S, typename T, bool DELTA, bool FAST>
__device__ __forceinline__ void collide_stream_halo3d_site(const Halo3In<S, T>& in, S* f_out,
                                                           S* g_out, T* rho_q,
                                                           const Halo3Geom& gm, int64_t esite,
                                                           const Params<T>& p) {
  const int NZ = gm.NZ, NY = gm.NY, NX = gm.NX;
  const int64_t eplane = static_cast<int64_t>(NY + 2 * gm.yh) * NX;
  const int ze = static_cast<int>(esite / eplane);
  const int64_t rem = esite - ze * eplane;
  const int ye = static_cast<int>(rem / NX);
  const int x = static_cast<int>(rem - static_cast<int64_t>(ye) * NX);
  // the source site in shard coordinates: z in [-zh, NZ + zh), y likewise
  const int z = ze - gm.zh;
  const int y = ye - gm.yh;
  const bool zin = z >= 0 && z < NZ;
  const bool yin = y >= 0 && y < NY;

  // which source holds it, its plane stride there and its offset in a plane
  Src3<S, T> src;
  int64_t vol, off;
  if (zin && yin) {
    src = in.shard;
    vol = static_cast<int64_t>(NZ) * NY * NX;
    off = (static_cast<int64_t>(z) * NY + y) * NX + x;
  } else if (yin) {
    src = z < 0 ? in.slice_up : in.slice_dn;
    vol = static_cast<int64_t>(NY) * NX;
    off = static_cast<int64_t>(y) * NX + x;
  } else if (zin) {
    src = y < 0 ? in.row_up : in.row_dn;
    vol = static_cast<int64_t>(NZ) * NX;
    off = static_cast<int64_t>(z) * NX + x;
  } else {
    src = z < 0 ? (y < 0 ? in.up_above : in.up_below) : (y < 0 ? in.dn_above : in.dn_below);
    vol = NX;
    off = x;
  }

  const int64_t out_plane = static_cast<int64_t>(NY) * NX;
  const int64_t out_vol = out_plane * NZ;
  const int xo[3] = {x == 0 ? NX - 1 : x - 1, x, x == NX - 1 ? 0 : x + 1};
  const T rq = collide_site3d<S, T, DELTA, FAST>(
      src.f, src.g, vol, off, src.ex[off], src.ey[off], src.ez[off], p,
      [&](int s, int i, T fo, T go) {
        int zd = z + cz3_of(i);
        int yd = y + cy3_of(i);
        if (gm.zh) {
          if (zd < 0 || zd >= NZ) return;
        } else {
          zd = zd < 0 ? NZ - 1 : (zd >= NZ ? 0 : zd);
        }
        if (gm.yh) {
          if (yd < 0 || yd >= NY) return;
        } else {
          yd = yd < 0 ? NY - 1 : (yd >= NY ? 0 : yd);
        }
        const int64_t dst = (static_cast<int64_t>(s) * kQ3 + i) * out_vol + zd * out_plane +
                            static_cast<int64_t>(yd) * NX + xo[cx3_of(i) + 1];
        Io<S, T>::store(f_out + dst, fo);
        Io<S, T>::store(g_out + dst, go);
      });
  if (zin && yin) rho_q[off] = rq;
}

}  // namespace

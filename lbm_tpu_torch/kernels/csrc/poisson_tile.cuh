// The per-tile program of the tiled iterative Poisson solve
// (csrc/poisson_iter.cu): red-black Gauss-Seidel, SOR, or the 4-colour
// 9-point stencil (NPS) on one tile of phi held in shared memory, written
// once for the card and for the host. Built by nvcc, TILE_FOR is a
// block-stride loop and TILE_ROWS / TILE_COLS give each warp a row and its
// lanes every 32nd site of the row's colour; built by a host C++ compiler
// (the CPU test of this header), they are serial loops over the same
// indices, and the test runs the tiles one after another with the
// exchange between sweeps.
//
// The plane (NY, NX) is cut into ty x tx tiles; tile (a, b) holds rows
// [a NY / ty, (a + 1) NY / ty) and the columns cut the same way, so tiles
// that do not divide the grid differ by one row or column. A tile sits in
// shared memory with a ring of d sites (one a colour pass: 2 for GS and
// SOR, 4 for NPS) of copies of its neighbours' sites, i in [-d, h + d),
// j in [-d, w + d), each row split into its even-x and odd-x half-rows
// (Layout); the ring wraps around the plane. Colour pass c updates its
// colour's sites in place on the tile grown by d - 1 - c sites a side: a
// ring copy is updated as its owner updates it, from copies of the same
// values, so after the last pass the tile's own sites are exact although
// the ring was read once, at the start of the sweep. In-place updates
// equal the plain sweeps' out-of-place ones wherever no site has a
// neighbour of its own colour: always under interior-only updates, and
// under periodic walls when NX and NY are even (the caller sends odd
// periodic planes to the streaming loop, poisson_sweep.cuh). Colours
// follow the tile's own coordinates past the plane's edge: under periodic
// walls both axes are even, so they agree with the plane's; under
// interior-only updates no copy past the plane's edge is updated or read
// by an updated site, and no copy is written back. At the end of a sweep
// each tile writes its sites within d of its edges to one of two planes in
// global memory, the other holding the previous sweep's, and the next
// sweep's ring is read from it (TILE_LDCG: from L2, where other blocks'
// stores land) after the one grid barrier a sweep that carries the error.
//
// Bitwise equal to the plain sweeps of lbm_tpu_torch/ops/poisson.py, as
// the streaming loop is (poisson_sweep.cuh's header): the same expression
// order, built without fused multiply-adds; red is (x+y)%2 == 0, the NPS
// colour 2*(x%2)+(y%2) swept 0..3; interior-only restricts to
// 1 <= x < NX-1, 1 <= y < NY-1; the error is max |new - p| over the
// updated sites on the bit patterns of |x| (a NaN ends the loop after its
// sweep), and the stop test err >= tol runs in T.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define TILE_FN __device__ __forceinline__
#define TILE_HD __host__ __device__ __forceinline__
#define TILE_FOR(t, n) for (int t = static_cast<int>(threadIdx.x); t < (n); t += blockDim.x)
#define TILE_ROWS(i, n) \
  for (int i = static_cast<int>(threadIdx.x >> 5); i < (n); i += static_cast<int>(blockDim.x >> 5))
#define TILE_COLS(k, lo, hi) \
  for (int k = (lo) + static_cast<int>(threadIdx.x & 31); k < (hi); k += 32)
#define TILE_LDCG(p) __ldcg(p)
#else
#define TILE_FN inline
#define TILE_HD inline
#define TILE_FOR(t, n) for (int t = 0; t < (n); ++t)
#define TILE_ROWS(i, n) for (int i = 0; i < (n); ++i)
#define TILE_COLS(k, lo, hi) for (int k = (lo); k < (hi); ++k)
#define TILE_LDCG(p) (*(p))
#endif

namespace ptile {

enum Kind { kGS = 0, kSOR = 1, kNPS = 2 };


// bit patterns of non-negative floats, ordered as the values, NaN above inf
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = uint32_t;
  static constexpr U kInf = 0x7f800000u;
  static constexpr U kAbs = 0x7fffffffu;   // |x|: the sign bit cleared
  static TILE_HD U of(float v) {
#if defined(__CUDA_ARCH__)
    return __float_as_uint(v);
#else
    U u;
    std::memcpy(&u, &v, sizeof u);
    return u;
#endif
  }
  static TILE_HD float val(U u) {
#if defined(__CUDA_ARCH__)
    return __uint_as_float(u);
#else
    float v;
    std::memcpy(&v, &u, sizeof v);
    return v;
#endif
  }
};
template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kInf = 0x7ff0000000000000ull;
  static constexpr U kAbs = 0x7fffffffffffffffull;
  static TILE_HD U of(double v) {
#if defined(__CUDA_ARCH__)
    return static_cast<U>(__double_as_longlong(v));
#else
    U u;
    std::memcpy(&u, &v, sizeof u);
    return u;
#endif
  }
  static TILE_HD double val(U u) {
#if defined(__CUDA_ARCH__)
    return __longlong_as_double(static_cast<long long>(u));
#else
    double v;
    std::memcpy(&v, &u, sizeof v);
    return v;
#endif
  }
};

// ty x tx tiles of an (NY, NX) plane
struct Tiling {
  int NY, NX, ty, tx;
};

struct Tile {
  int y0, x0, h, w;
};

TILE_HD int cut(int a, int n, int parts) {
  return static_cast<int>(static_cast<int64_t>(a) * n / parts);
}

TILE_HD Tile tile_of(const Tiling& g, int id) {
  const int a = id / g.tx, b = id - a * g.tx;
  const int y0 = cut(a, g.NY, g.ty), x0 = cut(b, g.NX, g.tx);
  return Tile{y0, x0, cut(a + 1, g.NY, g.ty) - y0, cut(b + 1, g.NX, g.tx) - x0};
}

// the ring's depth: one site a colour pass, so that a sweep needs its
// neighbours' values only once (GS and SOR 2, NPS 4)
TILE_HD int ring_depth(int kind) { return kind == kNPS ? 4 : 2; }

// A row of the tile and its ring is held as two half-rows, the sites of
// even x then those of odd x (x unwrapped), so that one colour's sites of
// a row, and each of their neighbours, lie at consecutive addresses:
// site (i, j), x = x0 + j, sits at ((i + d) 2 + x % 2) hw + (x - xbase) / 2
// with xbase the even x at or before x0 - d, and hw half-row slots.
struct Layout {
  int d, xbase, hw;
};

TILE_HD Layout layout_of(const Tile& t, int d) {
  const int xbase = (t.x0 - d) & ~1;
  return Layout{d, xbase, ((t.x0 + t.w + d - 1 - xbase) >> 1) + 1};
}

TILE_HD int at(const Tile& t, const Layout& L, int i, int j) {
  const int x = t.x0 + j;
  return ((i + L.d) * 2 + (x & 1)) * L.hw + ((x - L.xbase) >> 1);
}

// the floats (of T) a tile and its ring take in shared memory
TILE_HD int tile_floats(const Tile& t, const Layout& L) { return (t.h + 2 * L.d) * 2 * L.hw; }

// the largest tile's shared-memory bytes, ring included
inline int64_t tile_bytes(const Tiling& g, int depth, int itemsize) {
  const int64_t h = (g.NY + g.ty - 1) / g.ty, w = (g.NX + g.tx - 1) / g.tx;
  return (h + 2 * depth) * 2 * (((w + 2 * depth) >> 1) + 1) * itemsize;
}

// the cut of the plane into at most max_tiles tiles with the least
// (h + 2 d) (w + 2 d) + 16 d h: the largest tile with its ring, a ring
// column site charged as a 32-byte sector of its own
inline Tiling choose_tiling(int NY, int NX, int depth, int max_tiles) {
  Tiling best{NY, NX, 1, 1};
  int64_t best_cost = -1;
  for (int ty = 1; ty <= NY && ty <= max_tiles; ++ty) {
    for (int tx = 1; tx <= NX && ty * tx <= max_tiles; ++tx) {
      const int64_t h = (NY + ty - 1) / ty, w = (NX + tx - 1) / tx;
      const int64_t cost = (h + 2 * depth) * (w + 2 * depth) + 16 * depth * h;
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = Tiling{NY, NX, ty, tx};
      }
    }
  }
  return best;
}

// in-place colour passes equal the plain sweeps' out-of-place ones: no
// site reads a neighbour of its own colour (periodic walls wrap an odd
// axis onto the same parity); and the ring wraps at most once
TILE_HD bool in_place_equals_plain(bool interior, int NY, int NX) {
  return (interior || ((NX & 1) == 0 && (NY & 1) == 0)) && NY >= 4 && NX >= 4;
}

// v in [-n, 2 n) onto [0, n)
TILE_HD int wrap(int v, int n) { return v < 0 ? v + n : (v >= n ? v - n : v); }

template <typename T>
struct Coeffs {
  T omega, one_minus_omega;
};

// the tile and its ring from the plane src
template <typename T>
TILE_FN void load_tile(const T* src, T* S, const Tile& t, const Layout& L, int NY, int NX) {
  const int d = L.d, sw = t.w + 2 * d;
  TILE_FOR(e, (t.h + 2 * d) * sw) {
    const int i = e / sw - d, j = e % sw - d;
    const int y = wrap(t.y0 + i, NY), x = wrap(t.x0 + j, NX);
    S[at(t, L, i, j)] = TILE_LDCG(src + static_cast<int64_t>(y) * NX + x);
  }
}

// the ring alone: rows [-d, 0) and [h, h + d) over the whole ring width,
// then columns [-d, 0) and [w, w + d) of rows [0, h)
template <typename T>
TILE_FN void read_ring(const T* src, T* S, const Tile& t, const Layout& L, int NY, int NX) {
  const int d = L.d, sw = t.w + 2 * d, band = d * sw;
  TILE_FOR(e, 2 * band + 2 * d * t.h) {
    int i, j;
    if (e < 2 * band) {
      const int f = e < band ? e : e - band;
      i = f / sw - d + (e < band ? 0 : t.h + d);
      j = f % sw - d;
    } else {
      const int f = e - 2 * band, g = f / (2 * d), k = f % (2 * d);
      i = g;
      j = k < d ? k - d : t.w + k - d;
    }
    const int y = wrap(t.y0 + i, NY), x = wrap(t.x0 + j, NX);
    S[at(t, L, i, j)] = TILE_LDCG(src + static_cast<int64_t>(y) * NX + x);
  }
}

// the tile's sites within d of its edges (every site of a tile less than
// 2 d across) to the plane: what the neighbours' rings hold
template <typename T>
TILE_FN void publish_border(T* dst, const T* S, const Tile& t, const Layout& L, int NX) {
  const int d = L.d;
  const int top = t.h < 2 * d ? t.h : d;   // rows [0, top) and [h - top, h)
  const int side = t.w < 2 * d ? t.w : d;  // the middle rows' columns
  const int rows2 = t.h - top < top ? t.h - top : top;
  const int mid = t.h - top - rows2;
  TILE_FOR(e, (top + rows2) * t.w + mid * 2 * side) {
    int i, j;
    if (e < (top + rows2) * t.w) {
      const int r = e / t.w;
      i = r < top ? r : t.h - rows2 + (r - top);
      j = e % t.w;
    } else {
      const int f = e - (top + rows2) * t.w, k = f % (2 * side);
      i = top + f / (2 * side);
      j = k < side ? k : t.w - 2 * side + k;
    }
    dst[static_cast<int64_t>(t.y0 + i) * NX + t.x0 + j] = S[at(t, L, i, j)];
  }
}

// the whole tile to the plane
template <typename T>
TILE_FN void store_tile(T* dst, const T* S, const Tile& t, const Layout& L, int NX) {
  TILE_FOR(e, t.h * t.w) {
    const int i = e / t.w, j = e - i * t.w;
    dst[static_cast<int64_t>(t.y0 + i) * NX + t.x0 + j] = S[at(t, L, i, j)];
  }
}

// One colour pass in place on the tile grown by `grow` sites a side (the
// ring's copies of neighbour sites are updated as their owners update
// them, from the same values): returns the largest bit pattern of
// |new - p| over the tile's own sites this thread (on the host: the tile)
// updated, folded into `local`. rho is the plane, or with rho_tiled a copy
// laid out as S (load_tile's), in shared memory where it fits. Colours and
// the interior rule follow the tile's own (unwrapped) coordinates, so
// under interior-only updates no copy past the plane's edge is updated.
template <typename T, int KIND, bool INTERIOR>
TILE_FN typename Bits<T>::U colour_pass(T* S, const T* rho, bool rho_tiled, const Tile& t,
                                        const Layout& L, int grow, int NY, int NX, int c,
                                        const Coeffs<T>& k, typename Bits<T>::U local) {
  using U = typename Bits<T>::U;
  const int rs = 2 * L.hw;                             // a row's stride
  const int H = t.h + 2 * grow, W = t.w + 2 * grow;   // the grown region
  const int ya = t.y0 - grow, xa = t.x0 - grow;       // its first site
  // NPS: colour c lives on rows of parity c % 2, columns of parity c / 2;
  // red-black: every row, columns of parity (c + y) % 2. A warp takes a
  // row, its lanes every 32nd site of the colour: consecutive slots of
  // the row's half-row of that parity, their x neighbours consecutive
  // slots of the other half-row.
  const int row_step = KIND == kNPS ? 2 : 1;
  const int i0 = KIND == kNPS ? ((c & 1) - ya) & 1 : 0;
  const int rows = (H - i0 + row_step - 1) / row_step;
  TILE_ROWS(ii, rows) {
    const int yu = ya + i0 + ii * row_step;          // unwrapped row
    if (INTERIOR && (yu < 1 || yu > NY - 2)) continue;
    const int i = yu - t.y0;                          // tile row
    const int j0 = KIND == kNPS ? ((c >> 1) - xa) & 1 : (c - xa - yu) & 1;
    const int xs = xa + j0;                           // the row's first site, x
    // the row's sites are x = xs + 2 kk, kk in [lo, hi)
    int lo = 0, hi = (W - j0 + 1) >> 1;
    if (INTERIOR) {
      lo = xs >= 1 ? 0 : (2 - xs) >> 1;
      const int last = NX - 2 - xs;                   // x <= NX - 2
      hi = last < 0 ? 0 : (hi < (last >> 1) + 1 ? hi : (last >> 1) + 1);
    }
    // the tile's own sites: x in [x0, x0 + w)
    const bool own_row = i >= 0 && i < t.h;
    const int own_lo = t.x0 - xs <= 0 ? 0 : (t.x0 - xs + 1) >> 1;
    const int own_hi = (t.x0 + t.w - xs + 1) >> 1;
    const int par = xs & 1;
    const int s0 = at(t, L, i, xs - t.x0);            // slot of kk = 0
    const int o0 = (par ? s0 - L.hw : s0 + L.hw) - (par ? 0 : 1);  // its x - 1
    const int y = wrap(yu, NY);
    const T* rho_row = rho_tiled ? rho + s0 : rho + static_cast<int64_t>(y) * NX;
    TILE_COLS(kk, lo, hi) {
      const int s = s0 + kk, o = o0 + kk;
#if defined(__CUDA_ARCH__)
      const T r = rho_tiled ? rho_row[kk] : __ldg(rho_row + wrap(xs + 2 * kk, NX));
#else
      const T r = rho_row[rho_tiled ? kk : wrap(xs + 2 * kk, NX)];
#endif
      const T p = S[s];
      const T nb5 = ((S[o] + S[o + 1]) + S[s - rs]) + S[s + rs];
      T v;
      if (KIND == kNPS) {
        const T nbd = ((S[o - rs] + S[o - rs + 1]) + S[o + rs]) + S[o + rs + 1];
        v = ((T(4.0) * nb5 + nbd) + T(6.0) * r) / T(20.0);
      } else {
        v = T(0.25) * (nb5 + r);
        if (KIND == kSOR) v = k.one_minus_omega * p + k.omega * v;
      }
      S[s] = v;
      if (own_row && kk >= own_lo && kk < own_hi) {
        const U dd = Bits<T>::of(v - p) & Bits<T>::kAbs;
        local = dd > local ? dd : local;
      }
    }
  }
  return local;
}

}  // namespace ptile

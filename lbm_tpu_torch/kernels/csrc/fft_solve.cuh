// The arithmetic of the spectral Poisson + E solve (csrc/fft_solve.cu): the
// per-block programs of its three passes, written once for the card and
// for the host. Built by nvcc, FFT_FOR is a block-stride loop and FFT_SYNC
// a __syncthreads(); built by a host C++ compiler (the CPU test of this
// header), FFT_FOR is a serial loop over the same indices. Within a round
// every index touches only its own elements, so both orders give the same
// bits.
//
// A block holds L lines of length N (a power of two) in shared memory as
// two float planes (re, im). Element n of line l sits at
// l * (N + N/32 + 1) + n + n/32: one pad word every 32 elements spreads a
// work item's strided reads over the banks, and the odd line stride does
// the same for a column panel's loads, where neighbouring threads take
// neighbouring lines.
//
//   forward:  decimation in frequency, natural order in, bit-reversed
//             order out (position p holds wavenumber bitrev(p));
//   inverse:  decimation in time, unnormalised, bit-reversed order in,
//             natural order out.
//
// Each transform runs in rounds of up to four radix-2 stages (radix 16):
// a work item loads the 2^M elements r + k q (k < 2^M) of one group of
// 2^M q, q = 2^lq, runs a 2^M-point DFT on them in registers with
// constant twiddles, and multiplies output k by w_{2^M q}^(r bitrev(k)),
// one table twiddle an element. That is M radix-2 stages in another
// order of roundings; a 2048-point line takes three rounds (4 + 4 + 3
// stages) and three barriers. The inverse runs the same rounds mirrored
// with conjugate twiddles. Complex products use fused multiply-adds
// (FFT_FMA, __fmaf_rn on the card, std::fma on the host), explicitly:
// the library builds with -fmad=false, and this kernel is held at 1e-5 of
// scale, not bitwise.
//
// The column pass reads a scratch tiled by column panels: element (y, p)
// of the complex scratch sits at ((p / P) NY + y) P + p % P, so a panel is
// one contiguous run of NY P complex values, and the row passes write and
// read runs of (rows a block) * P values.
//
// So no pass reorders anything: the k-space multiply reads its symbols from
// tables that the host builds in the same bit-reversed order. The twiddle
// table holds w_N^k = exp(-2 pi i k / N) for k < N; it and the symbols come
// from the host in float64, cast once to float32.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define FFT_FN __device__ __forceinline__
#define FFT_HD __host__ __device__ __forceinline__
#define FFT_FOR(t, n) for (int t = static_cast<int>(threadIdx.x); t < (n); t += blockDim.x)
#define FFT_SYNC() __syncthreads()
#define FFT_FMA(a, b, c) __fmaf_rn(a, b, c)
#else
#include <cmath>
#define FFT_FN inline
#define FFT_HD inline
#define FFT_FOR(t, n) for (int t = 0; t < (n); ++t)
#define FFT_SYNC() ((void)0)
#define FFT_FMA(a, b, c) std::fma(a, b, c)
#endif

namespace fftsolve {

// shared-memory budgets: a block of K1 holds up to kRowSites rows' sites
// (K3 half as many); a column panel is widened up to 16 columns while it
// stays within kPanelBytes (three blocks an SM), and to at least 2 columns
// (16-byte runs; with K1's two rows a line, 32-byte runs of its stores)
// while it fits in a block
constexpr int kRowSites = 8192;
constexpr int kPanelBytes = 68 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kMaxPanel = 16;
constexpr int kMinPanel = 2;
constexpr int kMaxRadixLog = 4;   // radix 16: four stages a round

FFT_HD int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

FFT_HD int padded(int n) { return n + (n >> 5); }

// the low `bits` bits of p, reversed
FFT_HD int bitrev(int p, int bits) {
#if defined(__CUDA_ARCH__)
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(p)) >> (32 - bits));
#else
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((p >> b) & 1) << (bits - 1 - b);
  return r;
#endif
}

// floats of one plane (re or im) of `lines` lines of n points
FFT_HD int64_t plane_floats(int lines, int n) {
  return static_cast<int64_t>(lines) * (padded(n) + 1);
}

// shared-memory bytes of both planes
inline int64_t lines_bytes(int lines, int n) {
  return 2 * plane_floats(lines, n) * static_cast<int64_t>(sizeof(float));
}

// lines a block of the row passes holds: K3 transforms that many rows, K1
// twice as many (two real rows a complex line)
inline int rows_per_block(int NY, int NX) {
  int r = 1;
  while (4 * r <= NY && 2 * r * static_cast<int64_t>(NX) <= kRowSites) r *= 2;
  return r;
}

// columns a block of the column pass holds: the scratch's panel width
inline int cols_per_panel(int NY, int NX) {
  int p = 1;
  while (2 * p <= NX && 2 * p <= kMaxPanel && lines_bytes(2 * p, NY) <= kPanelBytes) p *= 2;
  while (p < kMinPanel && 2 * p <= NX && lines_bytes(2 * p, NY) <= kMaxSharedBytes) p *= 2;
  return p;
}

struct Lines {
  float* re;
  float* im;
  int log_n;  // N = 1 << log_n
  int lines;  // L
};

FFT_FN int stride_of(const Lines& s) { return padded(1 << s.log_n) + 1; }

// complex element i of an interleaved (re, im) float array in global
// memory: one 8-byte access on the card (the read-only path for tables)
FFT_FN void ld2(const float* a, int64_t i, float& re, float& im) {
#if defined(__CUDACC__)
  const float2 v = reinterpret_cast<const float2*>(a)[i];
  re = v.x;
  im = v.y;
#else
  re = a[2 * i];
  im = a[2 * i + 1];
#endif
}
FFT_FN void ldg2(const float* a, int64_t i, float& re, float& im) {
#if defined(__CUDACC__)
  const float2 v = __ldg(reinterpret_cast<const float2*>(a) + i);
  re = v.x;
  im = v.y;
#else
  re = a[2 * i];
  im = a[2 * i + 1];
#endif
}
FFT_FN void st2(float* a, int64_t i, float re, float im) {
#if defined(__CUDACC__)
  reinterpret_cast<float2*>(a)[i] = make_float2(re, im);
#else
  a[2 * i] = re;
  a[2 * i + 1] = im;
#endif
}

// cos and sin of 2 pi e / 16, e < 8
FFT_HD constexpr float cos16(int e) {
  return e == 0   ? 1.0f
         : e == 1 ? 0.923879532511286756f
         : e == 2 ? 0.707106781186547524f
         : e == 3 ? 0.382683432365089772f
         : e == 4 ? 0.0f
         : e == 5 ? -0.382683432365089772f
         : e == 6 ? -0.707106781186547524f
                  : -0.923879532511286756f;
}
FFT_HD constexpr float sin16(int e) { return cos16(e <= 4 ? 4 - e : e - 4); }

// x times w_16^e = exp(-2 pi i e / 16) (INV: its conjugate), e < 8 a
// constant after unrolling: e = 0 and e = 4 (-i, or +i) cost no product
template <bool INV>
FFT_FN void rot16(float& re, float& im, int e) {
  if (e == 0) return;
  if (e == 4) {
    const float t = re;
    re = INV ? -im : im;
    im = INV ? t : -t;
    return;
  }
  const float c = cos16(e), s = sin16(e);
  const float r = re, i = im;
  if (INV) {
    re = FFT_FMA(r, c, -(i * s));
    im = FFT_FMA(i, c, r * s);
  } else {
    re = FFT_FMA(r, c, i * s);
    im = FFT_FMA(i, c, -(r * s));
  }
}

// 2^M-point DFT in registers: natural order in, bit-reversed order out
template <int M>
FFT_FN void dft_dif(float* xr, float* xi) {
  constexpr int P = 1 << M;
#pragma unroll
  for (int st = 0; st < M; ++st) {
    const int d = P >> (st + 1);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k & d) continue;
      const float ar = xr[k], ai = xi[k], br = xr[k + d], bi = xi[k + d];
      xr[k] = ar + br;
      xi[k] = ai + bi;
      xr[k + d] = ar - br;
      xi[k + d] = ai - bi;
      rot16<false>(xr[k + d], xi[k + d], (k & (d - 1)) * (8 / d));
    }
  }
}

// its unnormalised inverse: bit-reversed order in, natural order out
template <int M>
FFT_FN void dft_dit(float* xr, float* xi) {
  constexpr int P = 1 << M;
#pragma unroll
  for (int st = M - 1; st >= 0; --st) {
    const int d = P >> (st + 1);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k & d) continue;
      float br = xr[k + d], bi = xi[k + d];
      rot16<true>(br, bi, (k & (d - 1)) * (8 / d));
      const float ar = xr[k], ai = xi[k];
      xr[k] = ar + br;
      xi[k] = ai + bi;
      xr[k + d] = ar - br;
      xi[k + d] = ai - bi;
    }
  }
}

// One round of M stages over every line: DIF (forward) spans 2^(M-1) q
// down to q; DIT (inverse) the same spans upwards, conjugate twiddles.
template <int M, bool INV>
FFT_FN void round_of(const Lines& s, const float* tw, int lq) {
  constexpr int P = 1 << M;
  const int q = 1 << lq;
  const int litems = s.log_n - M;       // work items a line: N / P
  const int wshift = s.log_n - M - lq;  // N / (P q)
  const int ls = stride_of(s);
  FFT_FOR(t, s.lines << litems) {
    const int l = t >> litems, j = t & ((1 << litems) - 1);
    const int g = j >> lq, r = j & (q - 1);
    const int line = l * ls, first = (g << (lq + M)) + r;
    float xr[P], xi[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int at = line + padded(first + (k << lq));
      xr[k] = s.re[at];
      xi[k] = s.im[at];
    }
    if (!INV) dft_dif<M>(xr, xi);
    if (lq > 0) {  // q = 1: r = 0, every twiddle is 1
#pragma unroll
      for (int k = 1; k < P; ++k) {
        const int m = (r * bitrev(k, M)) << wshift;
        float wr, wi;
        ldg2(tw, m, wr, wi);
        const float a = xr[k], b = xi[k];
        if (INV) {
          xr[k] = FFT_FMA(a, wr, b * wi);
          xi[k] = FFT_FMA(b, wr, -(a * wi));
        } else {
          xr[k] = FFT_FMA(a, wr, -(b * wi));
          xi[k] = FFT_FMA(a, wi, b * wr);
        }
      }
    }
    if (INV) dft_dit<M>(xr, xi);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int at = line + padded(first + (k << lq));
      s.re[at] = xr[k];
      s.im[at] = xi[k];
    }
  }
  FFT_SYNC();
}

template <bool INV>
FFT_FN void round_m(const Lines& s, const float* tw, int lq, int m) {
  if (m == 4) round_of<4, INV>(s, tw, lq);
  else if (m == 3) round_of<3, INV>(s, tw, lq);
  else if (m == 2) round_of<2, INV>(s, tw, lq);
  else round_of<1, INV>(s, tw, lq);
}

// forward over every line: natural in, bit-reversed out; spans N/2 down
// to 1, four stages a round, the remainder in the last (q = 1) round
FFT_FN void dif_forward(const Lines& s, const float* tw) {
  for (int lh = s.log_n - 1; lh >= 0;) {
    const int m = lh + 1 < kMaxRadixLog ? lh + 1 : kMaxRadixLog;
    round_m<false>(s, tw, lh - m + 1, m);
    lh -= m;
  }
}

// unnormalised inverse over every line: bit-reversed in, natural out; the
// forward's rounds in reverse order
FFT_FN void dit_inverse(const Lines& s, const float* tw) {
  int m = (s.log_n - 1) % kMaxRadixLog + 1;
  for (int lq = 0; lq < s.log_n; lq += m, m = kMaxRadixLog) round_m<true>(s, tw, lq, m);
}

// Everything a pass reads besides its data. sym_* hold (sin^2(pi k/N),
// sin(2 pi k/N)) per position of the bit-reversed layout; tw_* the N
// twiddles (re, im) of each axis; scale = 1 / (NY NX).
struct Tables {
  const float* tw_x;
  const float* tw_y;
  const float* sym_x;
  const float* sym_y;
  float scale;
};

// index (in complex elements) of (row y, position p) in the panel-tiled
// scratch of panel width P = 1 << lp
FFT_HD int64_t tiled(int y, int p, int NY, int lp) {
  return ((static_cast<int64_t>(p >> lp) * NY) + y) * (1 << lp) + (p & ((1 << lp) - 1));
}

// K1, one block: rows [2 b R, 2 b R + 2 R) of rho, two real rows a
// complex line (row 2l the real part, row 2l + 1 the imaginary), forward
// over x; each row's spectrum is split from the line's, A[k] =
// (Z[k] + conj Z[-k]) / 2 and B[k] = (Z[k] - conj Z[-k]) / 2i, into the
// tiled complex scratch (x in bit-reversed order)
FFT_FN void rows_forward_pair_block(int b, const float* rho, float* scratch, const Tables& tb,
                                    float* sre, float* sim, int NY, int NX, int R, int P) {
  const int lnx = log2i(NX), lr = log2i(2 * R), lp = log2i(P);
  const Lines s{sre, sim, lnx, R};
  const int ls = stride_of(s);
  const int64_t row0 = static_cast<int64_t>(b) * 2 * R;
  FFT_FOR(t, R << lnx) {
    const int l = t >> lnx, n = t & (NX - 1);
    sre[l * ls + padded(n)] = rho[(row0 + 2 * l) * NX + n];
    sim[l * ls + padded(n)] = rho[(row0 + 2 * l + 1) * NX + n];
  }
  FFT_SYNC();
  dif_forward(s, tb.tw_x);
  // e walks (panel, row, position in the panel), so a block writes runs
  // of 2 R P complex values
  FFT_FOR(e, (2 * R) << lnx) {
    const int within = e & (P - 1), rest = e >> lp;
    const int rr = rest & (2 * R - 1), p = ((rest >> lr) << lp) + within;
    const int pm = bitrev((NX - bitrev(p, lnx)) & (NX - 1), lnx);  // holds -k
    const int line = (rr >> 1) * ls;
    const float zr = sre[line + padded(p)], zi = sim[line + padded(p)];
    const float mr = sre[line + padded(pm)], mi = sim[line + padded(pm)];
    const int64_t at = tiled(static_cast<int>(row0) + rr, p, NY, lp);
    if ((rr & 1) == 0) st2(scratch, at, 0.5f * (zr + mr), 0.5f * (zi - mi));
    else st2(scratch, at, 0.5f * (zi + mi), 0.5f * (mr - zr));
  }
}

// K2, one block: panel b (columns [b P, b P + P)) of the scratch, forward
// over y, the k-space multiply C = Z (inv sy - i inv sx), inv = scale /
// (4 (sin^2 + sin^2)) or 0 where that is <= 1e-15 (the k = 0 mode),
// inverse over y, back in place
FFT_FN void panel_solve_block(int b, float* scratch, const Tables& tb, float* sre, float* sim,
                              int NY, int NX, int P) {
  const int lny = log2i(NY), lp = log2i(P);
  const Lines s{sre, sim, lny, P};
  const int ls = stride_of(s);
  float* panel = scratch + 2 * static_cast<int64_t>(b) * NY * P;
  FFT_FOR(e, P << lny) {
    const int at = (e & (P - 1)) * ls + padded(e >> lp);
    ld2(panel, e, sre[at], sim[at]);
  }
  FFT_SYNC();
  dif_forward(s, tb.tw_y);
  FFT_FOR(t, P << lny) {
    const int l = t >> lny, q = t & (NY - 1);
    const int p = b * P + l;
    float siny2, sy, sinx2, sx;
    ldg2(tb.sym_y, q, siny2, sy);
    ldg2(tb.sym_x, p, sinx2, sx);
    const float denom = 4.0f * (siny2 + sinx2);
    const float inv = denom > 1e-15f ? tb.scale / denom : 0.0f;
    const float a = inv * sy, bb = inv * sx;
    const int at = l * ls + padded(q);
    const float zr = sre[at], zi = sim[at];
    sre[at] = FFT_FMA(zr, a, zi * bb);
    sim[at] = FFT_FMA(zi, a, -(zr * bb));
  }
  FFT_SYNC();
  dit_inverse(s, tb.tw_y);
  FFT_FOR(e, P << lny) {
    const int at = (e & (P - 1)) * ls + padded(e >> lp);
    st2(panel, e, sre[at], sim[at]);
  }
  (void)NX;
}

// K3, one block: rows [b R, b R + R) of the tiled scratch, inverse over
// x, into Ex = Re and Ey = Im
FFT_FN void rows_inverse_block(int b, const float* scratch, float* ex, float* ey,
                               const Tables& tb, float* sre, float* sim, int NY, int NX, int R,
                               int P) {
  const int lnx = log2i(NX), lr = log2i(R), lp = log2i(P);
  const Lines s{sre, sim, lnx, R};
  const int ls = stride_of(s);
  const int64_t row0 = static_cast<int64_t>(b) * R;
  FFT_FOR(e, R << lnx) {
    const int within = e & (P - 1), rest = e >> lp;
    const int rr = rest & (R - 1), p = ((rest >> lr) << lp) + within;
    const int at = rr * ls + padded(p);
    ld2(scratch, tiled(static_cast<int>(row0) + rr, p, NY, lp), sre[at], sim[at]);
  }
  FFT_SYNC();
  dit_inverse(s, tb.tw_x);
  FFT_FOR(t, R << lnx) {
    const int l = t >> lnx, n = t & (NX - 1);
    ex[(row0 + l) * NX + n] = sre[l * ls + padded(n)];
    ey[(row0 + l) * NX + n] = sim[l * ls + padded(n)];
  }
}

}  // namespace fftsolve

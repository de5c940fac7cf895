// The arithmetic of the spectral Poisson + E solve (csrc/fft_solve.cu): the
// per-block programs of its three passes, written once for the card and
// for the host. Built by nvcc, FFT_FOR is a block-stride loop and FFT_SYNC
// a __syncthreads(); built by a host C++ compiler (the CPU test of this
// header), FFT_FOR is a serial loop over the same indices. Within a stage
// every index touches only its own elements, so both orders give the same
// bits.
//
// A block holds L lines of length N (a power of two) in shared memory as
// two float planes (re, im). Element n of line l sits at
// l * (N + N/32 + 1) + n + n/32: one pad word every 32 elements spreads a
// work item's strided reads (up to 8 elements 1-4 apart) over the banks,
// and the odd line stride does the same for a column panel's loads, where
// neighbouring threads take neighbouring lines.
//
//   forward:  radix-2 decimation in frequency, natural order in,
//             bit-reversed order out (position p holds wavenumber
//             bitrev(p));
//   inverse:  radix-2 decimation in time, unnormalised, bit-reversed order
//             in, natural order out;
// up to three stages at a time in registers, one barrier for each three.
//
// So no pass reorders anything: the k-space multiply reads its symbols from
// tables that the host builds in the same bit-reversed order. Twiddles
// w_N^k = exp(-2 pi i k / N), k < N/2, and the symbols come from the host
// in float64, cast once to float32.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define FFT_FN __device__ __forceinline__
#define FFT_HD __host__ __device__ __forceinline__
#define FFT_FOR(t, n) for (int t = static_cast<int>(threadIdx.x); t < (n); t += blockDim.x)
#define FFT_SYNC() __syncthreads()
#define FFT_LDG(p) __ldg(p)
#else
#define FFT_FN inline
#define FFT_HD inline
#define FFT_FOR(t, n) for (int t = 0; t < (n); ++t)
#define FFT_SYNC() ((void)0)
#define FFT_LDG(p) (*(p))
#endif

namespace fftsolve {

// shared-memory budgets: a row block holds up to kRowSites sites; a column
// panel is widened up to 16 columns while it stays within kPanelBytes, and
// to at least 4 columns (32-byte row segments) while it fits in a block
constexpr int kRowSites = 4096;
constexpr int kPanelBytes = 68 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kMaxPanel = 16;
constexpr int kMinPanel = 4;

FFT_HD int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

FFT_HD int padded(int n) { return n + (n >> 5); }

// floats of one plane (re or im) of `lines` lines of n points
FFT_HD int64_t plane_floats(int lines, int n) {
  return static_cast<int64_t>(lines) * (padded(n) + 1);
}

// shared-memory bytes of both planes
inline int64_t lines_bytes(int lines, int n) {
  return 2 * plane_floats(lines, n) * static_cast<int64_t>(sizeof(float));
}

// rows a block of the row passes holds
inline int rows_per_block(int NY, int NX) {
  int r = 1;
  while (2 * r <= NY && 2 * r * static_cast<int64_t>(NX) <= kRowSites) r *= 2;
  return r;
}

// columns a block of the column pass holds
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

// M consecutive radix-2 stages of every line, held in registers: a work
// item takes the 2^M elements r + k q (k < 2^M) of one group of 2^M q,
// q = 2^lq, runs the M stages on them and stores them back, so the block
// meets one barrier for M stages. Each element goes through the same
// operations, in the same order, as in M separate radix-2 stages.
// DIF (forward): spans 2^(M-1) q down to q. DIT (inverse, b times
// conj(w)): spans q up to 2^(M-1) q.
template <int M, bool DIT>
FFT_FN void stage_group(const Lines& s, const float* tw, int lq) {
  constexpr int P = 1 << M;
  const int lhalf = s.log_n - 1;
  const int q = 1 << lq;
  const int litems = s.log_n - M;  // work items a line: N / P
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
#pragma unroll
    for (int n = 0; n < M; ++n) {
      const int st = DIT ? n : M - 1 - n;  // slot distance 2^st, span 2^st q
      const int d = 1 << st;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (k & d) continue;
        // offset in its group of two spans, times N / (2 span)
        const int w = (r + ((k & (d - 1)) << lq)) << (lhalf - lq - st);
        const float wr = FFT_LDG(tw + 2 * w), wi = FFT_LDG(tw + 2 * w + 1);
        if (DIT) {
          const float br = xr[k + d], bi = xi[k + d];
          const float tr = br * wr + bi * wi;
          const float ti = bi * wr - br * wi;
          const float ar = xr[k], ai = xi[k];
          xr[k] = ar + tr;
          xi[k] = ai + ti;
          xr[k + d] = ar - tr;
          xi[k + d] = ai - ti;
        } else {
          const float ar = xr[k], ai = xi[k], br = xr[k + d], bi = xi[k + d];
          const float dr = ar - br, di = ai - bi;
          xr[k] = ar + br;
          xi[k] = ai + bi;
          xr[k + d] = dr * wr - di * wi;
          xi[k + d] = dr * wi + di * wr;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int at = line + padded(first + (k << lq));
      s.re[at] = xr[k];
      s.im[at] = xi[k];
    }
  }
  FFT_SYNC();
}

// up to 3 stages a barrier
template <bool DIT>
FFT_FN void stages(const Lines& s, const float* tw, int lq, int m) {
  if (m == 3) stage_group<3, DIT>(s, tw, lq);
  else if (m == 2) stage_group<2, DIT>(s, tw, lq);
  else stage_group<1, DIT>(s, tw, lq);
}

// forward DIF over every line: natural in, bit-reversed out; spans N/2
// down to 1
FFT_FN void dif_forward(const Lines& s, const float* tw) {
  for (int lh = s.log_n - 1; lh >= 0;) {
    const int m = lh + 1 < 3 ? lh + 1 : 3;
    stages<false>(s, tw, lh - m + 1, m);
    lh -= m;
  }
}

// unnormalised inverse DIT over every line: bit-reversed in, natural out;
// spans 1 up to N/2
FFT_FN void dit_inverse(const Lines& s, const float* tw) {
  for (int lh = 0; lh <= s.log_n - 1;) {
    const int m = s.log_n - lh < 3 ? s.log_n - lh : 3;
    stages<true>(s, tw, lh, m);
    lh += m;
  }
}

// Everything a pass reads besides its data. sym_* hold (sin^2(pi k/N),
// sin(2 pi k/N)) per position of the bit-reversed layout; tw_* the N/2
// twiddles (re, im) of each axis; scale = 1 / (NY NX).
struct Tables {
  const float* tw_x;
  const float* tw_y;
  const float* sym_x;
  const float* sym_y;
  float scale;
};

// K1, one block: rows [b R, b R + R) of rho, forward over x, into the
// complex scratch (interleaved re, im; x in bit-reversed order)
FFT_FN void rows_forward_block(int b, const float* rho, float* scratch, const Tables& tb,
                               float* sre, float* sim, int NY, int NX, int R) {
  const int lnx = log2i(NX);
  const Lines s{sre, sim, lnx, R};
  const int ls = stride_of(s);
  const int64_t row0 = static_cast<int64_t>(b) * R;
  FFT_FOR(t, R << lnx) {
    const int l = t >> lnx, n = t & (NX - 1);
    sre[l * ls + padded(n)] = rho[(row0 + l) * NX + n];
    sim[l * ls + padded(n)] = 0.0f;
  }
  FFT_SYNC();
  dif_forward(s, tb.tw_x);
  FFT_FOR(t, R << lnx) {
    const int l = t >> lnx, n = t & (NX - 1);
    const int64_t at = 2 * ((row0 + l) * NX + n);
    scratch[at] = sre[l * ls + padded(n)];
    scratch[at + 1] = sim[l * ls + padded(n)];
  }
  (void)NY;
}

// K2, one block: columns [b P, b P + P) of the scratch, forward over y,
// the k-space multiply C = Z (inv sy - i inv sx), inv = scale / (4 (sin^2
// + sin^2)) or 0 where that is <= 1e-15 (the k = 0 mode), inverse over y,
// back in place
FFT_FN void cols_solve_block(int b, float* scratch, const Tables& tb, float* sre, float* sim,
                             int NY, int NX, int P) {
  const int lny = log2i(NY), lp = log2i(P);
  const Lines s{sre, sim, lny, P};
  const int ls = stride_of(s);
  const int c0 = b * P;
  FFT_FOR(t, P << lny) {
    const int n = t >> lp, l = t & (P - 1);
    const int64_t at = 2 * (static_cast<int64_t>(n) * NX + c0 + l);
    sre[l * ls + padded(n)] = scratch[at];
    sim[l * ls + padded(n)] = scratch[at + 1];
  }
  FFT_SYNC();
  dif_forward(s, tb.tw_y);
  FFT_FOR(t, P << lny) {
    const int l = t >> lny, q = t & (NY - 1);
    const int p = c0 + l;
    const float siny2 = FFT_LDG(tb.sym_y + 2 * q), sy = FFT_LDG(tb.sym_y + 2 * q + 1);
    const float sinx2 = FFT_LDG(tb.sym_x + 2 * p), sx = FFT_LDG(tb.sym_x + 2 * p + 1);
    const float denom = 4.0f * (siny2 + sinx2);
    const float inv = denom > 1e-15f ? tb.scale / denom : 0.0f;
    const float a = inv * sy, bb = inv * sx;
    const int at = l * ls + padded(q);
    const float zr = sre[at], zi = sim[at];
    sre[at] = zr * a + zi * bb;
    sim[at] = zi * a - zr * bb;
  }
  FFT_SYNC();
  dit_inverse(s, tb.tw_y);
  FFT_FOR(t, P << lny) {
    const int n = t >> lp, l = t & (P - 1);
    const int64_t at = 2 * (static_cast<int64_t>(n) * NX + c0 + l);
    scratch[at] = sre[l * ls + padded(n)];
    scratch[at + 1] = sim[l * ls + padded(n)];
  }
}

// K3, one block: rows [b R, b R + R) of the scratch, inverse over x, into
// Ex = Re and Ey = Im
FFT_FN void rows_inverse_block(int b, const float* scratch, float* ex, float* ey,
                               const Tables& tb, float* sre, float* sim, int NY, int NX,
                               int R) {
  const int lnx = log2i(NX);
  const Lines s{sre, sim, lnx, R};
  const int ls = stride_of(s);
  const int64_t row0 = static_cast<int64_t>(b) * R;
  FFT_FOR(t, R << lnx) {
    const int l = t >> lnx, n = t & (NX - 1);
    const int64_t at = 2 * ((row0 + l) * NX + n);
    sre[l * ls + padded(n)] = scratch[at];
    sim[l * ls + padded(n)] = scratch[at + 1];
  }
  FFT_SYNC();
  dit_inverse(s, tb.tw_x);
  FFT_FOR(t, R << lnx) {
    const int l = t >> lnx, n = t & (NX - 1);
    ex[(row0 + l) * NX + n] = sre[l * ls + padded(n)];
    ey[(row0 + l) * NX + n] = sim[l * ls + padded(n)];
  }
  (void)NY;
}

}  // namespace fftsolve

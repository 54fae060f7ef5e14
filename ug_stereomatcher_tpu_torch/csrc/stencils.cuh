// Per-pixel and per-tile math shared by the per-iteration kernels
// (warp.cu, direction.cu, smooth.cu) and the level-resident kernel
// (level.cu).  Both routes compile these same functions under
// --fmad=false, so they round alike and the resident kernel is bit-exact
// against the per-iteration chain.
//
// Loads go through a policy: LdPlain for the per-iteration kernels, whose
// inputs are never written while they run, and for shared memory; LdL2
// (ld.global.cg, cached in L2 only) for the planes the level-resident
// kernel reads after other blocks wrote them, before the last grid
// barrier; the non-coherent L1 must not serve those.
//
// Row-sharded (row-halo) forms: a shard's planes hold a band of the
// image's rows, and every boundary (the zero and clamp edges, the kept
// row 0) resolves at the image's global rows 0 and H - 1, never at the
// band's edges.  RowBlock says where the bands lie; whole_image(H) is the
// unsharded case, for which every index below reduces to the plain one.
#pragma once

#include "common.cuh"

namespace ugsm {

// The output planes hold `out_rows` rows from global row `row0`; the
// haloed input planes hold `in_rows` rows from global row `in_row0`
// (row0 - halo); H is the image's height.
struct RowBlock {
  int H, row0, out_rows, in_row0, in_rows;
};

__host__ __device__ inline RowBlock whole_image(int H) {
  return RowBlock{H, 0, H, 0, H};
}

__host__ __device__ inline RowBlock row_block(int H, int row0, int out_rows,
                                              int halo) {
  return RowBlock{H, row0, out_rows, row0 - halo, out_rows + 2 * halo};
}

struct LdPlain {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
};

struct LdL2 {
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldcg(p);
  }
};

// ------------------------------------------------------------------ warp
// The backward warp of a (C, H, W) source by a two-axis field at global
// row r and column x, clamp addressing.  Nearest: point sampling, the
// floor of (x + 0.5) + dh and (r + 0.5) + dv.  Bilinear: four taps in the
// convention of CUDA's texture linear filter (weights from coord - 0.5),
// but with the weights computed in float32 instead of the texture unit's
// 9-bit fixed point, in tex_gather's term order (top = v00*(1-ax) +
// v01*ax, bot = v10*(1-ax) + v11*ax, out = top*(1-ay) + bot*ay).  fmaxf
// maps NaN to 0, so no field can address outside the plane.  Offsets are
// 32-bit: callers keep C * H * W below 2^31.  warp.cu and level.cu both
// warp through these, so the two routes round alike.

// Offset in a plane of the nearest tap.
__device__ __forceinline__ int nearest_tap(int H, int W, int r, int x,
                                           float dh, float dv) {
  float fx = floorf(((float)x + 0.5f) + dh);
  float fy = floorf(((float)r + 0.5f) + dv);
  fx = fminf(fmaxf(fx, 0.0f), (float)(W - 1));
  fy = fminf(fmaxf(fy, 0.0f), (float)(H - 1));
  return (int)fy * W + (int)fx;
}

struct BilinearTaps {
  int p00, p01, p10, p11;  // offsets in a plane: (top, bottom) x (left, right)
  float ax, ay;            // weights of the right and the bottom taps
};

__device__ __forceinline__ BilinearTaps bilinear_taps(int H, int W, int r,
                                                      int x, float dh,
                                                      float dv) {
  const float xf = (((float)x + 0.5f) + dh) - 0.5f;
  const float yf = (((float)r + 0.5f) + dv) - 0.5f;
  const float x0 = floorf(xf), y0 = floorf(yf);
  const int ix0 = (int)fminf(fmaxf(x0, 0.0f), (float)(W - 1));
  const int ix1 = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)(W - 1));
  const int iy0 = (int)fminf(fmaxf(y0, 0.0f), (float)(H - 1)) * W;
  const int iy1 = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)(H - 1)) * W;
  return BilinearTaps{iy0 + ix0, iy0 + ix1, iy1 + ix0, iy1 + ix1, xf - x0,
                      yf - y0};
}

__device__ __forceinline__ float bilinear_mix(float v00, float v01, float v10,
                                              float v11, float ax, float ay) {
  const float top = v00 * (1.0f - ax) + v01 * ax;
  const float bot = v10 * (1.0f - ax) + v11 * ax;
  return top * (1.0f - ay) + bot * ay;
}

// out[c * out_plane + p] = the warp of img's channel c at (r, x), c < C.
template <bool BILINEAR>
__device__ __forceinline__ void warp_px(const float* __restrict__ img,
                                        float* __restrict__ out, int C,
                                        int H, int W, int out_plane, int p,
                                        int r, int x, float dh, float dv) {
  const int plane = H * W;
  if (!BILINEAR) {
    const int src = nearest_tap(H, W, r, x, dh, dv);
    for (int c = 0; c < C; ++c) out[c * out_plane + p] = img[c * plane + src];
    return;
  }
  const BilinearTaps t = bilinear_taps(H, W, r, x, dh, dv);
  for (int c = 0; c < C; ++c) {
    const float* __restrict__ s = img + c * plane;
    out[c * out_plane + p] =
        bilinear_mix(s[t.p00], s[t.p01], s[t.p10], s[t.p11], t.ax, t.ay);
  }
}

// ------------------------------------------------------ separable blur
// A window of a plane of the image: rows of `pitch` floats from `base`,
// whose first row and column are the image's row0 and col0 (0, 0 for a
// whole plane in device memory; a tile's region in shared memory).
// at(r, c) reads the image's (r, c) through the load policy, with
// offsets of type I (int for a window in shared memory).
template <class Ld, class I = size_t>
struct PlaneAt {
  const float* base;
  int pitch, row0, col0;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return Ld::ld(base + (I)(r - row0) * pitch + (c - col0));
  }
};

// The clamp-boundary separable 5-tap blur of one plane at (r, c) of the
// H x W image, with the row-pass values the column pass needs recomputed
// in place.  This rounds exactly like the separable blur (row pass of
// the clamped rows, then the column pass; conv1d's term order), so no
// intermediate plane and no barrier between the passes is needed.  The
// taps within R of the centre must be nonzero and those beyond zero:
// R = 2 for the Gaussian, R = 1 for the 3-tap average (conv1d skips zero
// taps, so these terms are all of its terms).  SQUARE blurs x*x.  `at`
// must hold every clamped neighbour it is asked for.
template <bool SQUARE, int R, class At>
__device__ __forceinline__ float sep5_clamp_at(const At& at, int r, int c,
                                               int H, int W,
                                               const Taps5& tp) {
  static_assert(R == 1 || R == 2, "a 3- or 5-tap blur");
  int cols[2 * R + 1];
#pragma unroll
  for (int j = -R; j <= R; ++j) cols[j + R] = clampi(c + j, 0, W - 1);
  float acc = 0.0f;
#pragma unroll
  for (int k = -R; k <= R; ++k) {
    const int rr = clampi(r + k, 0, H - 1);
    float racc = 0.0f;
#pragma unroll
    for (int j = -R; j <= R; ++j) {
      float v = at(rr, cols[j + R]);
      if (SQUARE) v = v * v;
      const float term = tp.t[2 - j] * v;
      racc = j == -R ? term : racc + term;
    }
    const float term = tp.t[2 - k] * racc;
    acc = k == -R ? term : acc + term;
  }
  return acc;
}

// ------------------------------------------------------------- smooth
// One smoothing pass at (r, x) of a window of the H x W image in shared
// memory (rows from ra, columns from ca, rows of rw floats, planes of
// `plane` floats): the confidence-weighted plus-stencil mean of the
// 3-plane state, weighted by plane 2 (the confidence), in the term order
// of ops/smooth.py (centre, left, right, up, down; num / den).  Global
// row 0 and column 0 keep their values; clamp addressing at the image's
// edges.  Every neighbour (r, x) reads, clamped to the image, must lie
// in the window.
__device__ __forceinline__ void smooth_px_window(const float* in, float* out,
                                                 int plane, int rw, int ra,
                                                 int ca, int H, int W, int r,
                                                 int x) {
  const int p = (r - ra) * rw + (x - ca);
  if (r == 0 || x == 0) {
    for (int c = 0; c < 3; ++c) out[c * plane + p] = in[c * plane + p];
    return;
  }
  const int pr = p + (x + 1 < W ? 1 : 0);
  const int pd = p + (r + 1 < H ? rw : 0);
  const float* cf = in + 2 * plane;
  const float cc = cf[p], cl = cf[p - 1], cr = cf[pr], cu = cf[p - rw],
              cd = cf[pd];
  float den = cc;
  den = den + cl;
  den = den + cr;
  den = den + cu;
  den = den + cd;
  float res[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* v = in + c * plane;
    float num = v[p] * cc;
    num = num + v[p - 1] * cl;
    num = num + v[pr] * cr;
    num = num + v[p - rw] * cu;
    num = num + v[pd] * cd;
    res[c] = num / den;
  }
  // every load before any store, so the confidence loads serve plane 2
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * plane + p] = res[c];
}

// n smoothing passes over a window of the H x W image in shared memory:
// rows ra .. rb - 1 and columns ca .. cb - 1 of the 3 planes, rows of
// cb - ca floats, in two buffers of 3 planes of wp floats each (win holds
// the window; pass s reads buffer (s - 1) & 1 and writes buffer s & 1).
// A pass spoils one more line at each side of the window that is not the
// image's edge, so pass s computes only the lines at least s from such a
// side (one pixel a thread in turn, as a flat index over the region);
// the lines it leaves are stale.
// Every thread of the block must call this; the block is synchronised on
// return.  Returns the buffer after pass n.
__device__ __forceinline__ const float* smooth_window_passes(
    float* win, int wp, int ra, int rb, int ca, int cb, int H, int W,
    int n) {
  const int rw = cb - ca;
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int s = 1; s <= n; ++s) {
    const int lo_r = ra > 0 ? ra + s : 0, hi_r = rb < H ? rb - s : H;
    const int lo_c = ca > 0 ? ca + s : 0, hi_c = cb < W ? cb - s : W;
    const int cw = hi_c - lo_c;
    const float* in = win + ((s - 1) & 1) * 3 * wp;
    float* out = win + (s & 1) * 3 * wp;
    if (cw > 0) {
      // pixel i = tid + k nt of the region, row by row; (r, x) advance by
      // (nt / cw, nt % cw) with a carry, so no division per pixel
      const int dr = nt / cw, dx = nt - dr * cw;
      int r = lo_r + tid / cw, x = lo_c + tid % cw;
      for (; r < hi_r; r += dr, x += dx) {
        if (x >= hi_c) {
          x -= cw;
          ++r;
          if (r >= hi_r) break;
        }
        smooth_px_window(in, out, wp, rw, ra, ca, H, W, r, x);
      }
    }
    __syncthreads();
  }
  return win + (n & 1) * 3 * wp;
}

// ---------------------------------------------------------- direction
// The fused correlate -> parabola -> update step over one output tile
// (direction.cu, and phase A of level.cu).  For each channel and move d
// of MOVES (left, right, up, down, centre):
//   corr_d = clip(G0(L * W(x+d))^2 / (G(L^2) * Gc(W^2)(x+d)), 0, 1),
// G0 the zero-boundary blur of the cross product (zero outside the
// image), Gc(W^2) the clamp-boundary blur of the squared warped image
// read at the clamped shifted pixel; the channel mean, two parabola fits,
// the disparity update and the confidence blend (or replace).

struct DirConsts {
  float no_peak, aff_scale, aff_bias, w_new, w_old;
};

// PolyDisparity (ops/pointwise.py parabola_fit), one rounding per op.
__device__ __forceinline__ void parabola(float l, float c, float r, float thr,
                                         const DirConsts& k, float& offset,
                                         float& conf) {
  const float b1 = (r - l) * 0.5f;
  const float c1 = r - (c + b1);
  const bool has_peak = c1 < 0.0f;  // false for NaN input
  float off = (-b1 * 0.5f) / c1;
  off = fminf(thr, fmaxf(off, -thr));
  const float cstar = (c1 * off + b1) * off + c;
  const bool over = cstar > 1.0f;
  const float d = cstar - c;
  const float off_over = d > 1e-10f ? off * ((1.0f - c) / d) : off;
  const float conf_in = over ? 1.0f : k.aff_scale * cstar + k.aff_bias;
  const float off_in = over ? off_over : off;
  offset = has_peak ? off_in : 0.0f;
  conf = has_peak ? conf_in : k.no_peak;
}

// A tile of kTH = NS * S output rows by TW columns, run by a (TW, NS)
// thread block: thread (tx, ty) owns the S rows from tile row ty * S of
// column tx.  The three channels of L, W and Gc(W^2) are staged in shared
// memory once per tile (direction_stage_left, the caller's W,
// direction_gw2); after that a thread computes its strip from shared
// memory and registers, with no barrier (direction_update_tile).
template <int TW, int NS, int S>
struct DirTile {
  static constexpr int kTW = TW, kTH = NS * S, kRows = S, kThreads = TW * NS;
  static constexpr int LR = kTH + 4, LC = TW + 4;  // L: the tile +- 2
  static constexpr int WR = kTH + 6, WC = TW + 6;  // W: the tile +- 3
  static constexpr int GR = kTH + 2, GC = TW + 2;  // Gc(W^2): the tile +- 1
  float l[3][LR][LC];  // L, zero outside the image
  float w[3][WR][WC];  // W at the pixel clamped to the image
  float g[3][GR][GC];  // Gc(W^2) at the pixel clamped to the image
};

__device__ __forceinline__ int block_tid() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Start the cp.async copies of L (3 channels) over the tile +- 2 from
// global row grow0, column c0: zero outside the image.  BAND: left holds
// g.in_rows rows from global row g.in_row0 (a shard's haloed rows), and
// a row outside them stages zero; only rows past the shard's output read
// it.
template <bool BAND, class Tile>
__device__ __forceinline__ void direction_stage_left(Tile& t,
                                                     const float* left,
                                                     const RowBlock& g, int W,
                                                     int grow0, int c0) {
  constexpr int n = Tile::LR * Tile::LC;
  const int H = g.H;
  const int in_row0 = BAND ? g.in_row0 : 0;
  const int in_rows = BAND ? g.in_rows : H;
  const size_t hplane = (size_t)in_rows * W;
  for (int i = block_tid(); i < 3 * n; i += Tile::kThreads) {
    const int c = i / n, q = i - c * n;
    const int row = q / Tile::LC, col = q - row * Tile::LC;
    const int rr = grow0 - 2 + row, lr = rr - in_row0, cc = c0 - 2 + col;
    const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W &&
                        (!BAND || (lr >= 0 && lr < in_rows));
    cp_async4(&t.l[0][0][0] + i,
              inside ? left + c * hplane + (size_t)lr * W + cc : left,
              inside);
  }
}

// Start the cp.async copies of W (3 channels of `warped`, planes as left's
// in direction_stage_left) over the tile +- 3, at the pixel clamped to
// the image (and, under BAND, to the band's rows; only rows past the
// shard's output read a row clamped to the band).
template <bool BAND, class Tile>
__device__ __forceinline__ void direction_stage_warped(Tile& t,
                                                       const float* warped,
                                                       const RowBlock& g,
                                                       int W, int grow0,
                                                       int c0) {
  constexpr int n = Tile::WR * Tile::WC;
  const int H = g.H;
  const int in_row0 = BAND ? g.in_row0 : 0;
  const int in_rows = BAND ? g.in_rows : H;
  const size_t hplane = (size_t)in_rows * W;
  for (int i = block_tid(); i < 3 * n; i += Tile::kThreads) {
    const int c = i / n, q = i - c * n;
    const int row = q / Tile::WC, col = q - row * Tile::WC;
    const int rr = clampi(grow0 - 3 + row, 0, H - 1);
    const int lr = BAND ? clampi(rr - in_row0, 0, in_rows - 1) : rr;
    const int cc = clampi(c0 - 3 + col, 0, W - 1);
    cp_async4(&t.w[0][0][0] + i, warped + c * hplane + (size_t)lr * W + cc,
              true);
  }
}

// Gc(W^2) of the 3 channels over the tile +- 1, at the pixels clamped to
// the H x W image, from the staged W: the row pass of W^2 at the G
// columns over all of W's rows into `rows` (RC channels at a time: RC *
// WR * GC floats of shared memory), then the column pass into t.g.  Each
// value rounds as the blur kernel rounds it (the clamped neighbours, row
// pass first), and every clamped neighbour lies in the staged W.  Where
// the tile +- 3 lies inside the image (not EDGE) no index clamps.
template <int RC, bool EDGE, class Tile>
__device__ __forceinline__ void gw2_passes(Tile& t, float* rows, int H,
                                           int W, int grow0, int c0,
                                           const Taps5& tp) {
  constexpr int WR = Tile::WR, WC = Tile::WC, GR = Tile::GR, GC = Tile::GC;
  const int tid = block_tid();
  for (int cb = 0; cb < 3; cb += RC) {
    for (int i = tid; i < RC * WR * GC; i += Tile::kThreads) {
      const int cr = i / GC, j = i - cr * GC;  // cr: channel * WR + W row
      const float* wrow = &t.w[cb][0][0] + cr * WC;
      const int cc = clampi(c0 - 1 + j, 0, W - 1);
      float v[5];
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        // staged column j + d is image column c0 - 3 + j + d
        const float x =
            EDGE ? wrow[clampi(cc + d - 2, 0, W - 1) - (c0 - 3)] : wrow[j + d];
        v[d] = x * x;
      }
      rows[i] = pass5_all(tp, v[0], v[1], v[2], v[3], v[4]);
    }
    __syncthreads();
    for (int i = tid; i < RC * GR * GC; i += Tile::kThreads) {
      const int cg = i / GC, j = i - cg * GC;  // cg: channel * GR + G row
      const int cl = cg / GR, gi = cg - cl * GR;
      const int rr = clampi(grow0 - 1 + gi, 0, H - 1);
      const float* col = rows + cl * WR * GC + j;
      float v[5];
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        // row-pass row gi + d is image row grow0 - 3 + gi + d
        v[d] = EDGE ? col[(clampi(rr + d - 2, 0, H - 1) - (grow0 - 3)) * GC]
                    : col[(gi + d) * GC];
      }
      (&t.g[cb][0][0])[i] = pass5_all(tp, v[0], v[1], v[2], v[3], v[4]);
    }
    __syncthreads();
  }
}

// Gc(W^2) of the tile at global row grow0, column c0 into t.g (see
// gw2_passes).  Call after W is staged and the block has synchronised;
// ends synchronised.
template <int RC, class Tile>
__device__ __forceinline__ void direction_gw2(Tile& t, float* rows, int H,
                                              int W, int grow0, int c0,
                                              const Taps5& tp) {
  if (grow0 < 3 || grow0 + Tile::kTH + 3 > H || c0 < 3 ||
      c0 + Tile::kTW + 3 > W) {
    gw2_passes<RC, true>(t, rows, H, W, grow0, c0, tp);
  } else {
    gw2_passes<RC, false>(t, rows, H, W, grow0, c0, tp);
  }
}

// The row pass of one move's cross product at a row: L (columns x - 2 ..
// x + 2) times W at columns OFF - 3 .. OFF + 1 relative to x, zero where
// the L pixel lies outside the image (EDGE tiles only: elsewhere every
// pixel is inside).
template <bool EDGE, int OFF>
__device__ __forceinline__ float cross_pass(const Taps5& tp,
                                            const float (&lv)[5],
                                            const float (&wv)[7], bool rowok,
                                            const bool (&colok)[5]) {
  float x[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float p = lv[j] * wv[j + OFF];
    x[j] = (!EDGE || (rowok && colok[j])) ? p : 0.0f;
  }
  return pass5_all(tp, x[0], x[1], x[2], x[3], x[4]);
}

// One thread's S rows of the step, from the staged tile.  For each
// channel the thread walks down its strip +- 2 rows: per row it reads L
// (5 values) and the next row of W (7 values, the dx = -1 .. 1 shifts)
// once, keeps three rows of W in registers (the dy = -1 .. 1 shifts),
// computes the row pass of all five moves' cross products, and adds each
// to the column passes of the (at most five) output rows it reaches, in
// the column pass's term order.  An output row's column pass completes
// after its fifth row: the ratio with G(L^2) (from bl2) and the staged
// Gc(W^2), added to the channel sums.  Rows past out_rows and columns
// past W compute on staged values and store nothing.
template <class Ld, bool BAND, bool EDGE, class LdIn, class Tile>
__device__ __forceinline__ void direction_strip(
    const Tile& t, const float* bl2, const float* disp, float* out,
    const RowBlock& g, int W, int r0, int c0, float thr, bool replace,
    const Taps5& tp, const DirConsts& k) {
  constexpr int S = Tile::kRows;
  const int H = g.H;
  const int out_rows = BAND ? g.out_rows : H;
  const int grow0 = BAND ? g.row0 + r0 : r0;  // global row of the tile
  const int tx = threadIdx.x, rs = threadIdx.y * S;
  const int x = c0 + tx;
  const size_t plane = (size_t)out_rows * W;
  bool colok[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) colok[j] = x + j - 2 >= 0 && x + j - 2 < W;
  float acc[S][5] = {};  // the channel sums

  for (int c = 0; c < 3; ++c) {
    const float(*lc)[Tile::LC] = t.l[c];
    const float(*wc)[Tile::WC] = t.w[c];
    const float(*gc)[Tile::GC] = t.g[c];
    float b2[S];
#pragma unroll
    for (int o = 0; o < S; ++o) {
      const int r = r0 + rs + o;
      b2[o] = r < out_rows && x < W
                  ? LdIn::ld(bl2 + c * plane + (size_t)r * W + x)
                  : 1.0f;
    }
    // W rows q - 1, q and q + 1 of tile row q, columns x - 3 .. x + 3
    float wm[7], w0[7], wp[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      wm[j] = wc[rs][tx + j];
      w0[j] = wc[rs + 1][tx + j];
    }
    float col[S][5];
#pragma unroll
    for (int i = 0; i < S + 4; ++i) {  // tile row rs - 2 + i
      float lv[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) lv[j] = lc[rs + i][tx + j];
#pragma unroll
      for (int j = 0; j < 7; ++j) wp[j] = wc[rs + i + 2][tx + j];
      const int gr = grow0 + rs - 2 + i;
      const bool rowok = gr >= 0 && gr < H;
      float rp[5];
      rp[0] = cross_pass<EDGE, 0>(tp, lv, w0, rowok, colok);  // left
      rp[1] = cross_pass<EDGE, 2>(tp, lv, w0, rowok, colok);  // right
      rp[2] = cross_pass<EDGE, 1>(tp, lv, wm, rowok, colok);  // up
      rp[3] = cross_pass<EDGE, 1>(tp, lv, wp, rowok, colok);  // down
      rp[4] = cross_pass<EDGE, 1>(tp, lv, w0, rowok, colok);  // centre
#pragma unroll
      for (int o = 0; o < S; ++o) {
        const int d = i - o;  // this row is output row o's offset d - 2
        if (d < 0 || d > 4) continue;
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          col[o][m] = d == 0 ? tp.t[4] * rp[m]
                             : col[o][m] + tp.t[4 - d] * rp[m];
        }
        if (d < 4) continue;
        // Gc(W^2) at the clamped shifted pixel of output row o, by move
        const float* gq = &gc[rs + o + 1][tx + 1];
        const float gv[5] = {gq[-1], gq[1], gq[-Tile::GC], gq[Tile::GC],
                             gq[0]};
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          const float num = col[o][m] * col[o][m];
          const float den = b2[o] * gv[m];
          float ratio = num / den;
          if (ratio > 1.0f) ratio = 1.0f;  // NaN passes through, as in
          if (ratio < 0.0f) ratio = 0.0f;  // correlation_ratio
          acc[o][m] = c == 0 ? ratio : acc[o][m] + ratio;
        }
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        wm[j] = w0[j];
        w0[j] = wp[j];
      }
    }
  }

#pragma unroll
  for (int o = 0; o < S; ++o) {
    const int r = r0 + rs + o;
    if (r >= out_rows || x >= W) continue;
    const size_t p = (size_t)r * W + x;
    float d[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) d[m] = acc[o][m] * (1.0f / 3.0f);
    float inc_h, conf_h, inc_v, conf_v;
    parabola(d[0], d[4], d[1], thr, k, inc_h, conf_h);
    parabola(d[2], d[4], d[3], thr, k, inc_v, conf_v);
    const float conf_new = conf_h * conf_v;
    out[p] = inc_h + Ld::ld(disp + p);
    out[plane + p] = inc_v + Ld::ld(disp + plane + p);
    float blended =
        k.w_new * conf_new + k.w_old * Ld::ld(disp + 2 * plane + p);
    if (blended > 1.0f) blended = 1.0f;
    if (blended < 0.0f) blended = 0.0f;
    out[2 * plane + p] = replace ? conf_new : blended;
  }
}

// The step over the output tile at (r0, c0) of the output planes, from
// the staged tile t (after direction_gw2).  bl2, disp and out are the
// output planes (under BAND g.out_rows rows from global row g.row0, else
// the whole (3, g.H, W) image); bl2 loads through LdIn, disp through Ld.
// A tile whose L window (the tile +- 2) lies inside the image takes the
// form without the zero mask.  Reads only t, so the caller may restage
// after a barrier.
template <class Ld, bool BAND, class LdIn, class Tile>
__device__ __forceinline__ void direction_update_tile(
    const Tile& t, const float* bl2, const float* disp, float* out,
    const RowBlock& g, int W, int r0, int c0, float thr, bool replace,
    const Taps5& tp, const DirConsts& k) {
  const int grow0 = BAND ? g.row0 + r0 : r0;
  const bool edge = grow0 < 2 || grow0 + Tile::kTH + 2 > g.H || c0 < 2 ||
                    c0 + Tile::kTW + 2 > W;
  if (edge) {
    direction_strip<Ld, BAND, true, LdIn>(t, bl2, disp, out, g, W, r0, c0,
                                          thr, replace, tp, k);
  } else {
    direction_strip<Ld, BAND, false, LdIn>(t, bl2, disp, out, g, W, r0, c0,
                                           thr, replace, tp, k);
  }
}

}  // namespace ugsm

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
// out[c, p] = img[c] sampled at (x + 0.5 + dh, r + 0.5 + dv), clamp
// addressing, for the (C, H, W) source img and output planes of
// `out_plane` floats: r is the global row, p the output offset (the two
// differ for a shard's rows of the image).  Nearest: point sampling,
// floor of the coordinate.
// Bilinear: four taps in the convention of CUDA's texture linear filter
// (weights from coord - 0.5), but with the weights computed in float32
// instead of the texture unit's 9-bit fixed point, in tex_gather's term
// order
// (top = v00*(1-ax) + v01*ax, bot = v10*(1-ax) + v11*ax,
//  out = top*(1-ay) + bot*ay).  fmaxf maps NaN to 0, so no field can
// address outside the plane.
template <bool BILINEAR>
__device__ __forceinline__ void warp_px(const float* __restrict__ img,
                                        float* __restrict__ out, int C,
                                        int H, int W, size_t out_plane,
                                        size_t p, int r, int x, float dh,
                                        float dv) {
  const size_t plane = (size_t)H * W;
  if (!BILINEAR) {
    float fx = floorf(((float)x + 0.5f) + dh);
    float fy = floorf(((float)r + 0.5f) + dv);
    fx = fminf(fmaxf(fx, 0.0f), (float)(W - 1));
    fy = fminf(fmaxf(fy, 0.0f), (float)(H - 1));
    const size_t src = (size_t)(int)fy * W + (int)fx;
    for (int c = 0; c < C; ++c) out[c * out_plane + p] = img[c * plane + src];
    return;
  }
  const float xf = (((float)x + 0.5f) + dh) - 0.5f;
  const float yf = (((float)r + 0.5f) + dv) - 0.5f;
  const float x0 = floorf(xf), y0 = floorf(yf);
  const float ax = xf - x0, ay = yf - y0;
  const int ix0 = (int)fminf(fmaxf(x0, 0.0f), (float)(W - 1));
  const int ix1 = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)(W - 1));
  const int iy0 = (int)fminf(fmaxf(y0, 0.0f), (float)(H - 1));
  const int iy1 = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)(H - 1));
  const size_t p00 = (size_t)iy0 * W + ix0, p01 = (size_t)iy0 * W + ix1;
  const size_t p10 = (size_t)iy1 * W + ix0, p11 = (size_t)iy1 * W + ix1;
  for (int c = 0; c < C; ++c) {
    const float* __restrict__ s = img + c * plane;
    const float top = s[p00] * (1.0f - ax) + s[p01] * ax;
    const float bot = s[p10] * (1.0f - ax) + s[p11] * ax;
    out[c * out_plane + p] = top * (1.0f - ay) + bot * ay;
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
// H x W image, with the five row-pass values the column pass needs
// recomputed in place.  This rounds exactly like the two-pass tile of
// blur.cu (row pass of the clamped rows, then the column pass), so no
// intermediate plane and no barrier between the passes is needed.
// SQUARE blurs x*x.  `at` must hold every clamped neighbour it is asked
// for.
template <bool SQUARE, class At>
__device__ __forceinline__ float sep5_clamp_at(const At& at, int r, int c,
                                               int H, int W,
                                               const Taps5& tp) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = -2; k <= 2; ++k) {
    const float wk = tp.t[2 - k];
    if (wk == 0.0f) continue;
    const int rr = clampi(r + k, 0, H - 1);
    float racc = 0.0f;
    bool rfirst = true;
#pragma unroll
    for (int j = -2; j <= 2; ++j) {
      const float wj = tp.t[2 - j];
      if (wj == 0.0f) continue;
      float v = at(rr, clampi(c + j, 0, W - 1));
      if (SQUARE) v = v * v;
      const float term = wj * v;
      racc = rfirst ? term : racc + term;
      rfirst = false;
    }
    const float term = wk * racc;
    acc = first ? term : acc + term;
    first = false;
  }
  return acc;
}

// ------------------------------------------------------------- smooth
// The confidence-weighted plus-stencil mean at offset p of the 3-plane
// state `in` (planes of `plane` floats), from the centre and the four
// neighbour offsets (of type I), weighted by the confidence plane.  Term
// order of ops/smooth.py: centre, left, right, up, down; num / den.
template <class Ld, class I = size_t>
__device__ __forceinline__ void smooth_at(const float* in, float* out,
                                          I plane, I p, I pl, I pr, I pu,
                                          I pd) {
  const float* cf = in + 2 * plane;
  const float cc = Ld::ld(cf + p), cl = Ld::ld(cf + pl),
              cr = Ld::ld(cf + pr), cu = Ld::ld(cf + pu),
              cd = Ld::ld(cf + pd);
  float den = cc;
  den = den + cl;
  den = den + cr;
  den = den + cu;
  den = den + cd;
  for (int c = 0; c < 3; ++c) {
    const float* v = in + c * plane;
    float num = Ld::ld(v + p) * cc;
    num = num + Ld::ld(v + pl) * cl;
    num = num + Ld::ld(v + pr) * cr;
    num = num + Ld::ld(v + pu) * cu;
    num = num + Ld::ld(v + pd) * cd;
    out[c * plane + p] = num / den;
  }
}

// One smoothing pass at (r, x) over the 3-plane state: global row 0 and
// column 0 keep their values; clamp addressing at the image's edges.
// in and out hold g.in_rows rows from global row g.in_row0; r is a
// global row inside the image.  A neighbour row outside the band is
// clamped to the band: such a value is wrong, and a row-sharded caller
// gives the band enough halo rows that no output depends on it.
template <class Ld>
__device__ __forceinline__ void smooth_px(const float* in, float* out,
                                          const RowBlock& g, int W, int r,
                                          int x) {
  const size_t plane = (size_t)g.in_rows * W;
  const int lr = r - g.in_row0;
  const size_t p = (size_t)lr * W + x;
  if (r == 0 || x == 0) {
    for (int c = 0; c < 3; ++c) out[c * plane + p] = Ld::ld(in + c * plane + p);
    return;
  }
  const int down = r + 1 < g.H ? r + 1 : g.H - 1;
  smooth_at<Ld>(in, out, plane, p, p - 1,
                (size_t)lr * W + (x + 1 < W ? x + 1 : W - 1),
                (size_t)clampi(r - 1 - g.in_row0, 0, g.in_rows - 1) * W + x,
                (size_t)clampi(down - g.in_row0, 0, g.in_rows - 1) * W + x);
}

// The same pass on a window of the H x W image (rows from ra, columns
// from ca, rw columns, planes of `plane` floats), as the level kernel
// keeps in shared memory: every neighbour (r, x) reads, clamped to the
// image, must lie in the window.
__device__ __forceinline__ void smooth_px_window(const float* in, float* out,
                                                 int plane, int rw, int ra,
                                                 int ca, int H, int W, int r,
                                                 int x) {
  const int lr = r - ra;
  const int p = lr * rw + (x - ca);
  if (r == 0 || x == 0) {
    for (int c = 0; c < 3; ++c) out[c * plane + p] = in[c * plane + p];
    return;
  }
  const int down = r + 1 < H ? r + 1 : H - 1;
  smooth_at<LdPlain, int>(in, out, plane, p, p - 1,
                          lr * rw + ((x + 1 < W ? x + 1 : W - 1) - ca),
                          p - rw, (down - ra) * rw + (x - ca));
}

// ---------------------------------------------------------- direction
constexpr int kDirBX = 32;  // tile width = threads in x
constexpr int kDirBY = 16;  // tile height = threads in y

// MOVES (dx, dy) of config.py: left, right, up, down, centre.
__device__ __forceinline__ int move_dx(int m) {
  return m == 0 ? -1 : (m == 1 ? 1 : 0);
}
__device__ __forceinline__ int move_dy(int m) {
  return m == 2 ? -1 : (m == 3 ? 1 : 0);
}

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

// W, the warped right image, is staged over the tile +- 3 rows and
// columns, clamped to the image; Gc(W^2) is read at the tile +- 1.
constexpr int kWRows = kDirBY + 6;
constexpr int kWCols = kDirBX + 6;
using WRow = float[kWCols];

// W and Gc(W^2) for direction_tile_with from planes in device memory
// (the per-iteration kernels): W of channel c is staged into the shared
// `ws`, Gc(W^2) read from bw2 at the shifted, clamped pixel.  BAND as in
// direction_tile.
template <class Ld, bool BAND>
struct WarpedPlanes {
  const float* warped;
  const float* bw2;
  WRow* ws;
  RowBlock g;
  int W;

  __device__ __forceinline__ WRow* stage(int c, int grow0, int c0) const {
    const int H = g.H;
    const int in_row0 = BAND ? g.in_row0 : 0;
    const int in_rows = BAND ? g.in_rows : H;
    const float* wp = warped + c * ((size_t)in_rows * W);
    for (int i = threadIdx.y; i < kWRows; i += kDirBY) {
      const int rr = clampi(grow0 - 3 + i, 0, H - 1);
      const int lr = BAND ? clampi(rr - in_row0, 0, in_rows - 1) : rr;
      for (int j = threadIdx.x; j < kWCols; j += kDirBX) {
        const int cc = clampi(c0 - 3 + j, 0, W - 1);
        ws[i][j] = Ld::ld(wp + (size_t)lr * W + cc);
      }
    }
    return ws;
  }

  // Gc(W^2) of channel c at (clamp(gr + dy), clamp(gc + dx)), gr global.
  __device__ __forceinline__ float gw2(int c, int gr, int gc, int dy,
                                       int dx) const {
    const int H = g.H;
    const int in_row0 = BAND ? g.in_row0 : 0;
    const int in_rows = BAND ? g.in_rows : H;
    const size_t q = (size_t)(clampi(gr + dy, 0, H - 1) - in_row0) * W +
                     clampi(gc + dx, 0, W - 1);
    return Ld::ld(bw2 + c * ((size_t)in_rows * W) + q);
  }
};

// One 16 x 32 output tile (rows r0.., columns c0.. of the output planes)
// of the fused correlate -> parabola -> update step, run by a (32, 16)
// thread block.  Per channel, L (halo 2, zero outside the image) is
// staged in shared memory and W (halo 3, clamped to the image) comes from
// `wsrc` (stage(c, grow0, c0): the kWRows x kWCols tile of W, in shared
// memory once the block has synchronised); each move's cross product is
// built there, its row pass goes to a shared intermediate and its column
// pass to registers.  wsrc.gw2 gives the clamp-blurred W^2 through the
// clamped shift.  Ends with every shared read done, so a block may run
// the next tile straight away.
//
// BAND (the row-sharded form): bl2, disp and out are the output planes
// (g.out_rows rows from global row g.row0); left is a haloed plane
// (g.in_rows rows from g.in_row0, at least 3 rows of halo).  Every
// boundary resolves at global rows 0 and g.H - 1.  A tile row past the
// output rows stages zeros or clamped rows where the band ends; only
// that row's discarded result reads them.  Without BAND every plane is
// the whole (3, g.H, W) image and the band terms fold away.  left and bl2
// load through LdIn, disp through Ld.
template <class Ld, bool BAND, class WSrc, class LdIn = Ld>
__device__ __forceinline__ void direction_tile_with(
    const float* left, const float* bl2, const float* disp, float* out,
    const RowBlock& g, int W, int r0, int c0, float thr, bool replace,
    const Taps5& taps, const DirConsts& k, const WSrc& wsrc) {
  __shared__ float ls[kDirBY + 4][kDirBX + 4];  // L, rows/cols -2 .. +2
  __shared__ float xs[kDirBY + 4][kDirBX + 4];  // cross product, 0 outside
  __shared__ float rs[kDirBY + 4][kDirBX];      // row pass of xs
  const int H = g.H;
  const int in_row0 = BAND ? g.in_row0 : 0;
  const int in_rows = BAND ? g.in_rows : H;
  const int out_rows = BAND ? g.out_rows : H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gr = r0 + ty, gc = c0 + tx;
  const int grow0 = BAND ? g.row0 + r0 : r0;  // global row of the tile
  const bool valid = gr < out_rows && gc < W;
  const size_t plane = (size_t)out_rows * W;
  const size_t hplane = (size_t)in_rows * W;
  const size_t p = (size_t)gr * W + gc;
  float dirs[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int c = 0; c < 3; ++c) {
    const float* lp = left + c * hplane;
    for (int i = ty; i < kDirBY + 4; i += kDirBY) {
      const int rr = grow0 - 2 + i;
      const int lr = rr - in_row0;
      for (int j = tx; j < kDirBX + 4; j += kDirBX) {
        const int cc = c0 - 2 + j;
        const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W &&
                            (!BAND || (lr >= 0 && lr < in_rows));
        ls[i][j] = inside ? LdIn::ld(lp + (size_t)lr * W + cc) : 0.0f;
      }
    }
    WRow* ws = wsrc.stage(c, grow0, c0);
    __syncthreads();

#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int dx = move_dx(m), dy = move_dy(m);
      // cross = L * shift_image(W, dx, dy) inside the image, 0 outside
      // (the zero boundary of the cross-product blur).
      for (int i = ty; i < kDirBY + 4; i += kDirBY) {
        const int rr = grow0 - 2 + i;
        for (int j = tx; j < kDirBX + 4; j += kDirBX) {
          const int cc = c0 - 2 + j;
          const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W;
          xs[i][j] = inside ? ls[i][j] * ws[i + 1 + dy][j + 1 + dx] : 0.0f;
        }
      }
      __syncthreads();
      for (int i = ty; i < kDirBY + 4; i += kDirBY) {
        rs[i][tx] = pass5(taps, xs[i][tx], xs[i][tx + 1], xs[i][tx + 2],
                          xs[i][tx + 3], xs[i][tx + 4]);
      }
      __syncthreads();
      if (valid) {
        const float bc = pass5(taps, rs[ty][tx], rs[ty + 1][tx],
                               rs[ty + 2][tx], rs[ty + 3][tx],
                               rs[ty + 4][tx]);
        const float num = bc * bc;
        const float den = LdIn::ld(bl2 + c * plane + p) *
                          wsrc.gw2(c, grow0 + ty, gc, dy, dx);
        float ratio = num / den;
        if (ratio > 1.0f) ratio = 1.0f;  // NaN passes through, as in
        if (ratio < 0.0f) ratio = 0.0f;  // correlation_ratio
        dirs[m] = c == 0 ? ratio : dirs[m] + ratio;
      }
    }
    __syncthreads();  // every read of ls/ws done before the next channel
  }
  if (!valid) return;

  float d[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) d[m] = dirs[m] * (1.0f / 3.0f);
  float inc_h, conf_h, inc_v, conf_v;
  parabola(d[0], d[4], d[1], thr, k, inc_h, conf_h);
  parabola(d[2], d[4], d[3], thr, k, inc_v, conf_v);
  const float conf_new = conf_h * conf_v;
  out[p] = inc_h + Ld::ld(disp + p);
  out[plane + p] = inc_v + Ld::ld(disp + plane + p);
  float blended = k.w_new * conf_new + k.w_old * Ld::ld(disp + 2 * plane + p);
  if (blended > 1.0f) blended = 1.0f;
  if (blended < 0.0f) blended = 0.0f;
  out[2 * plane + p] = replace ? conf_new : blended;
}

// The tile of direction_tile_with with W staged from the warped planes and
// Gc(W^2) read from bw2 (both haloed planes under BAND).
template <class Ld, bool BAND = false>
__device__ __forceinline__ void direction_tile(
    const float* left, const float* warped, const float* bl2,
    const float* bw2, const float* disp, float* out, const RowBlock& g,
    int W, int r0, int c0, float thr, bool replace, const Taps5& taps,
    const DirConsts& k) {
  __shared__ float ws[kWRows][kWCols];  // W clamped, -3 .. +3
  direction_tile_with<Ld, BAND>(left, bl2, disp, out, g, W, r0, c0, thr,
                                replace, taps, k,
                                WarpedPlanes<Ld, BAND>{warped, bw2, ws, g, W});
}

}  // namespace ugsm

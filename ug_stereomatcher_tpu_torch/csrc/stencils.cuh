// Per-pixel and per-tile math shared by the per-iteration kernels
// (warp.cu, direction.cu, smooth.cu) and the level-resident kernel
// (level.cu).  Both routes compile these same functions under
// --fmad=false, so they round alike and the resident kernel is bit-exact
// against the per-iteration chain.
//
// Loads go through a policy: LdPlain for the per-iteration kernels, whose
// inputs are never written while they run, and LdL2 (ld.global.cg, cached
// in L2 only) for the level-resident kernel, which reads planes that other
// blocks wrote before the last grid barrier; the non-coherent L1 must not
// serve those.
#pragma once

#include "common.cuh"

namespace ugsm {

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
// addressing.  Nearest: point sampling, floor of the coordinate.
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
                                        int H, int W, int r, int x, float dh,
                                        float dv) {
  const size_t plane = (size_t)H * W;
  const size_t p = (size_t)r * W + x;
  if (!BILINEAR) {
    float fx = floorf(((float)x + 0.5f) + dh);
    float fy = floorf(((float)r + 0.5f) + dv);
    fx = fminf(fmaxf(fx, 0.0f), (float)(W - 1));
    fy = fminf(fmaxf(fy, 0.0f), (float)(H - 1));
    const size_t src = (size_t)(int)fy * W + (int)fx;
    for (int c = 0; c < C; ++c) out[c * plane + p] = img[c * plane + src];
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
    out[c * plane + p] = top * (1.0f - ay) + bot * ay;
  }
}

// ------------------------------------------------------ separable blur
// The clamp-boundary separable 5-tap blur of one plane at (r, c), with
// the five row-pass values the column pass needs recomputed in place.
// This rounds exactly like the two-pass tile of blur.cu (row pass of the
// clamped rows, then the column pass), so no intermediate plane and no
// barrier between the passes is needed.  SQUARE blurs x*x.
template <class Ld, bool SQUARE>
__device__ __forceinline__ float sep5_clamp_at(const float* x, int r, int c,
                                               int H, int W,
                                               const Taps5& tp) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = -2; k <= 2; ++k) {
    const float wk = tp.t[2 - k];
    if (wk == 0.0f) continue;
    const float* row = x + (size_t)clampi(r + k, 0, H - 1) * W;
    float racc = 0.0f;
    bool rfirst = true;
#pragma unroll
    for (int j = -2; j <= 2; ++j) {
      const float wj = tp.t[2 - j];
      if (wj == 0.0f) continue;
      float v = Ld::ld(row + clampi(c + j, 0, W - 1));
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
// One confidence-weighted plus-stencil pass at (r, x) over the (3, H, W)
// state, weighted by the confidence plane of `in`; row 0 and column 0
// keep their values; clamp addressing.  Term order of ops/smooth.py:
// centre, left, right, up, down; num / den.
template <class Ld>
__device__ __forceinline__ void smooth_px(const float* in, float* out, int H,
                                          int W, int r, int x) {
  const size_t plane = (size_t)H * W;
  const size_t p = (size_t)r * W + x;
  if (r == 0 || x == 0) {
    for (int c = 0; c < 3; ++c) out[c * plane + p] = Ld::ld(in + c * plane + p);
    return;
  }
  const float* cf = in + 2 * plane;
  const size_t pl = p - 1;
  const size_t pr = (size_t)r * W + (x + 1 < W ? x + 1 : W - 1);
  const size_t pu = p - W;
  const size_t pd = (size_t)(r + 1 < H ? r + 1 : H - 1) * W + x;
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

// One 16 x 32 output tile (rows r0.., columns c0..) of the fused
// correlate -> parabola -> update step, run by a (32, 16) thread block.
// Per channel, L (halo 2, zero outside) and W (halo 3, clamped) are
// staged in shared memory; each move's cross product is built there, its
// row pass goes to a shared intermediate and its column pass to
// registers.  bw2 is the clamp-blurred W^2, read through the clamped
// shift.  Ends with every shared read done, so a block may run the next
// tile straight away.
template <class Ld>
__device__ __forceinline__ void direction_tile(
    const float* left, const float* warped, const float* bl2,
    const float* bw2, const float* disp, float* out, int H, int W, int r0,
    int c0, float thr, bool replace, const Taps5& taps,
    const DirConsts& k) {
  __shared__ float ls[kDirBY + 4][kDirBX + 4];  // L, rows/cols -2 .. +2
  __shared__ float ws[kDirBY + 6][kDirBX + 6];  // W clamped, -3 .. +3
  __shared__ float xs[kDirBY + 4][kDirBX + 4];  // cross product, 0 outside
  __shared__ float rs[kDirBY + 4][kDirBX];      // row pass of xs
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gr = r0 + ty, gc = c0 + tx;
  const bool valid = gr < H && gc < W;
  const size_t plane = (size_t)H * W;
  const size_t p = (size_t)gr * W + gc;
  float dirs[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int c = 0; c < 3; ++c) {
    const float* lp = left + c * plane;
    const float* wp = warped + c * plane;
    for (int i = ty; i < kDirBY + 4; i += kDirBY) {
      const int rr = r0 - 2 + i;
      for (int j = tx; j < kDirBX + 4; j += kDirBX) {
        const int cc = c0 - 2 + j;
        const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W;
        ls[i][j] = inside ? Ld::ld(lp + (size_t)rr * W + cc) : 0.0f;
      }
    }
    for (int i = ty; i < kDirBY + 6; i += kDirBY) {
      const int rr = clampi(r0 - 3 + i, 0, H - 1);
      for (int j = tx; j < kDirBX + 6; j += kDirBX) {
        const int cc = clampi(c0 - 3 + j, 0, W - 1);
        ws[i][j] = Ld::ld(wp + (size_t)rr * W + cc);
      }
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int dx = move_dx(m), dy = move_dy(m);
      // cross = L * shift_image(W, dx, dy) inside the image, 0 outside
      // (the zero boundary of the cross-product blur).
      for (int i = ty; i < kDirBY + 4; i += kDirBY) {
        const int rr = r0 - 2 + i;
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
        const size_t q = (size_t)clampi(gr + dy, 0, H - 1) * W +
                         clampi(gc + dx, 0, W - 1);
        const float den = Ld::ld(bl2 + c * plane + p) *
                          Ld::ld(bw2 + c * plane + q);
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

}  // namespace ugsm

// Fused correlate -> parabola -> update step: the Hopper form of
// fused_direction_update (ug_stereomatcher_tpu/ops/pallas/direction.py).
//
// For each move d of MOVES (left, right, up, down, centre):
//   corr_d = clip(G0(L * W(x+d))^2 / (G(L^2) * Gc(W^2)(x+d)), 0, 1)
// averaged over the 3 channels, two parabola fits, the disparity update,
// and the confidence blend (or replace on the coarsest level's first
// iteration).  G0 is the zero-boundary blur of the cross product; Gc(W^2)
// is blurred with the clamp boundary and read through a clamped shift.
//
// Bound: on-chip work.  Each pixel needs 15 separable 5x5 blurs of cross
// products (about 300 flops) against 5 reads and 3 writes of device
// memory, so the design keeps every intermediate on the chip: one block
// per 16 x 32 output tile stages L (halo 2) and W (halo 3, clamped) in
// shared memory per channel, builds each move's cross product there,
// runs the row pass into a shared intermediate and the column pass into
// registers.  The five channel sums live in registers; only the new
// state is written.  Gc(W^2) is one clamp-boundary blur of the squared
// warped image run first into a scratch plane (the launch_sep5 kernel),
// because the shifted read needs it at clamped neighbours.
#include "common.cuh"

namespace {

constexpr int kBX = 32;  // tile width = threads in x
constexpr int kBY = 16;  // tile height = threads in y

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

__global__ void __launch_bounds__(kBX * kBY)
    direction_kernel(const float* __restrict__ left,
                     const float* __restrict__ warped,
                     const float* __restrict__ bl2,
                     const float* __restrict__ bw2,
                     const float* __restrict__ disp, float* __restrict__ out,
                     int H, int W, float thr, int replace, ugsm::Taps5 taps,
                     DirConsts k) {
  __shared__ float ls[kBY + 4][kBX + 4];  // L, rows/cols -2 .. +2
  __shared__ float ws[kBY + 6][kBX + 6];  // W clamped, rows/cols -3 .. +3
  __shared__ float xs[kBY + 4][kBX + 4];  // cross product, zero outside
  __shared__ float rs[kBY + 4][kBX];      // row pass of xs
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kBX, r0 = blockIdx.y * kBY;
  const int gr = r0 + ty, gc = c0 + tx;
  const bool valid = gr < H && gc < W;
  const size_t plane = (size_t)H * W;
  const size_t p = (size_t)gr * W + gc;
  float dirs[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int c = 0; c < 3; ++c) {
    const float* __restrict__ lp = left + c * plane;
    const float* __restrict__ wp = warped + c * plane;
    for (int i = ty; i < kBY + 4; i += kBY) {
      const int rr = r0 - 2 + i;
      for (int j = tx; j < kBX + 4; j += kBX) {
        const int cc = c0 - 2 + j;
        const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W;
        ls[i][j] = inside ? lp[(size_t)rr * W + cc] : 0.0f;
      }
    }
    for (int i = ty; i < kBY + 6; i += kBY) {
      const int rr = ugsm::clampi(r0 - 3 + i, 0, H - 1);
      for (int j = tx; j < kBX + 6; j += kBX) {
        const int cc = ugsm::clampi(c0 - 3 + j, 0, W - 1);
        ws[i][j] = wp[(size_t)rr * W + cc];
      }
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int dx = move_dx(m), dy = move_dy(m);
      // cross = L * shift_image(W, dx, dy) inside the image, 0 outside
      // (the zero boundary of the cross-product blur).
      for (int i = ty; i < kBY + 4; i += kBY) {
        const int rr = r0 - 2 + i;
        for (int j = tx; j < kBX + 4; j += kBX) {
          const int cc = c0 - 2 + j;
          const bool inside = rr >= 0 && rr < H && cc >= 0 && cc < W;
          xs[i][j] = inside ? ls[i][j] * ws[i + 1 + dy][j + 1 + dx] : 0.0f;
        }
      }
      __syncthreads();
      for (int i = ty; i < kBY + 4; i += kBY) {
        rs[i][tx] = ugsm::pass5(taps, xs[i][tx], xs[i][tx + 1], xs[i][tx + 2],
                                xs[i][tx + 3], xs[i][tx + 4]);
      }
      __syncthreads();
      if (valid) {
        const float bc = ugsm::pass5(taps, rs[ty][tx], rs[ty + 1][tx],
                                     rs[ty + 2][tx], rs[ty + 3][tx],
                                     rs[ty + 4][tx]);
        const float num = bc * bc;
        const size_t q = (size_t)ugsm::clampi(gr + dy, 0, H - 1) * W +
                         ugsm::clampi(gc + dx, 0, W - 1);
        const float den = bl2[c * plane + p] * bw2[c * plane + q];
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
  out[p] = inc_h + disp[p];
  out[plane + p] = inc_v + disp[plane + p];
  float blended = k.w_new * conf_new + k.w_old * disp[2 * plane + p];
  if (blended > 1.0f) blended = 1.0f;
  if (blended < 0.0f) blended = 0.0f;
  out[2 * plane + p] = replace ? conf_new : blended;
}

}  // namespace

// bw2: (3, H, W) scratch for the clamp-blurred squared warped image.
// Gaussian taps (t_outer, t_inner, t_centre); consts as MatcherConfig's
// (no_peak, affine_scale, affine_bias, blend_new, blend_old).
UGSM_API int ugsm_direction_update(const float* left, const float* warped,
                                   const float* bl2, const float* disp,
                                   float* bw2, float* out, int H, int W,
                                   float threshold, int replace, float t_outer,
                                   float t_inner, float t_centre,
                                   float no_peak, float aff_scale,
                                   float aff_bias, float w_new, float w_old,
                                   void* stream) {
  if (H < 1 || W < 1 || (H + kBY - 1) / kBY > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ugsm::Taps5 taps =
      ugsm::make_taps5(t_outer, t_inner, t_centre, t_inner, t_outer);
  ugsm::launch_sep5(warped, bw2, 3, H, W, /*clamp=*/1, /*square=*/1, taps, s);
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  const DirConsts k{no_peak, aff_scale, aff_bias, w_new, w_old};
  direction_kernel<<<grid, block, 0, s>>>(left, warped, bl2, bw2, disp, out,
                                          H, W, threshold, replace, taps, k);
  return (int)cudaGetLastError();
}

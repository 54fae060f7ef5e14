// Confidence-weighted smoothing chain: the Hopper form of
// fused_smooth_average (ug_stereomatcher_tpu/ops/pallas/smooth.py).
//
// n passes of the plus-stencil weighted mean over (disp_h, disp_v, conf),
// each weighted by the confidence from before that pass, with clamp
// addressing; row 0 and column 0 keep their values (MatchLib.cu:1106).
// Then the separable 3-tap average with the literal 0.3333 taps and the
// clamp boundary.
//
// Bound: device memory.  A pass reads 3 planes and writes 3 (with 5-point
// neighbourhoods that the L1 cache serves) and does about 35 flops per
// pixel.  Design: one launch per pass with ping-pong scratch planes, one
// thread per pixel, so each pass reads the whole previous state and no
// halo bookkeeping across passes is needed; the average runs as the
// shared-memory separable kernel of blur.cu with taps (0, a, a, a, 0).
// The term order is that of ops/smooth.py (centre, left, right, up,
// down; num / den), not the TPU kernel's reciprocal form.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    smooth_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int H, int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  const float* __restrict__ cf = in + 2 * plane;
  for (int r = blockIdx.y; r < H; r += gridDim.y) {
    const size_t p = (size_t)r * W + x;
    if (r == 0 || x == 0) {
      for (int c = 0; c < 3; ++c) out[c * plane + p] = in[c * plane + p];
      continue;
    }
    const size_t pl = p - 1;
    const size_t pr = (size_t)r * W + (x + 1 < W ? x + 1 : W - 1);
    const size_t pu = p - W;
    const size_t pd = (size_t)(r + 1 < H ? r + 1 : H - 1) * W + x;
    const float cc = cf[p], cl = cf[pl], cr = cf[pr], cu = cf[pu],
                cd = cf[pd];
    float den = cc;
    den = den + cl;
    den = den + cr;
    den = den + cu;
    den = den + cd;
    for (int c = 0; c < 3; ++c) {
      const float* __restrict__ v = in + c * plane;
      float num = v[p] * cc;
      num = num + v[pl] * cl;
      num = num + v[pr] * cr;
      num = num + v[pu] * cu;
      num = num + v[pd] * cd;
      out[c * plane + p] = num / den;
    }
  }
}

}  // namespace

// state: (3, H, W); out: (3, H, W); tmp_a/tmp_b: (3, H, W) scratch.
UGSM_API int ugsm_smooth_average(const float* state, float* out, float* tmp_a,
                                 float* tmp_b, int H, int W, int n_passes,
                                 float avg_tap, void* stream) {
  if (H < 1 || W < 1 || n_passes < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((W + kThreads - 1) / kThreads, H < 65535 ? H : 65535);
  const float* src = state;
  float* bufs[2] = {tmp_a, tmp_b};
  for (int i = 0; i < n_passes; ++i) {
    float* dst = bufs[i % 2];
    smooth_pass_kernel<<<grid, kThreads, 0, s>>>(src, dst, H, W);
    src = dst;
  }
  ugsm::launch_sep5(src, out, 3, H, W, /*clamp=*/1, /*square=*/0,
                    ugsm::make_taps5(0.0f, avg_tap, avg_tap, avg_tap, 0.0f),
                    s);
  return (int)cudaGetLastError();
}

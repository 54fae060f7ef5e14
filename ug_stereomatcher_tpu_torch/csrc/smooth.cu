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
// down; num / den), not the TPU kernel's reciprocal form; the per-pixel
// pass (smooth_px in stencils.cuh) is shared with level.cu.
#include "stencils.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    smooth_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int H, int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  for (int r = blockIdx.y; r < H; r += gridDim.y) {
    ugsm::smooth_px<ugsm::LdPlain>(in, out, H, W, r, x);
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

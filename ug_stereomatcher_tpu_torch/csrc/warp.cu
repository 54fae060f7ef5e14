// Nearest backward warp by a two-axis disparity field: the Hopper form of
// warp_windowed_dyn and warp_windowed (ug_stereomatcher_tpu/ops/pallas/
// warp.py), which replaces both of them, the planner plan_dyn_warp and
// the tier fallbacks of match.py.
//
//   out[c, r, x] = src[c, clamp(floor((r + 0.5) + dv)), clamp(floor((x + 0.5) + dh))]
//
// Bound: device memory (read dh, dv and 3 gathered floats, write 3).  The
// TPU kernels exist because Mosaic has no 2-D gather: they sweep a
// source window per row tile and need a planner and an exact fallback
// for fields that leave the window.  A GPU thread can read any address,
// so one direct gather per output pixel is exact for every field and
// needs no window.  Coordinates are computed in float32 exactly as
// _dest_coords + tex_gather do, so the result is bit-exact.  Smooth
// fields keep neighbouring threads on neighbouring source addresses.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ img, const float* __restrict__ dh,
                const float* __restrict__ dv, float* __restrict__ out, int C,
                int H, int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  for (int r = blockIdx.y; r < H; r += gridDim.y) {
    const size_t p = (size_t)r * W + x;
    float fx = floorf(((float)x + 0.5f) + dh[p]);
    float fy = floorf(((float)r + 0.5f) + dv[p]);
    // fmaxf maps NaN to 0, so no field can address outside the plane.
    fx = fminf(fmaxf(fx, 0.0f), (float)(W - 1));
    fy = fminf(fmaxf(fy, 0.0f), (float)(H - 1));
    const size_t src = (size_t)(int)fy * W + (int)fx;
    for (int c = 0; c < C; ++c) out[c * plane + p] = img[c * plane + src];
  }
}

}  // namespace

UGSM_API int ugsm_warp_nearest(const float* img, const float* dh,
                               const float* dv, float* out, int C, int H,
                               int W, void* stream) {
  if (C < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, H < 65535 ? H : 65535);
  warp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(img, dh, dv, out,
                                                          C, H, W);
  return (int)cudaGetLastError();
}

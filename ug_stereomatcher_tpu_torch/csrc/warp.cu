// Backward warp by a two-axis disparity field, nearest and bilinear: the
// Hopper form of warp_windowed_dyn and warp_windowed with their
// sweep_nearest / sweep_bilinear (ug_stereomatcher_tpu/ops/pallas/
// warp.py), which replaces both of them, the planner plan_dyn_warp and
// the tier fallbacks of match.py.
//
//   nearest:  out[c, r, x] = src[c, clamp(floor((r + 0.5) + dv)),
//                                   clamp(floor((x + 0.5) + dh))]
//   bilinear: the four clamped taps around ((x + 0.5) + dh) - 0.5 and
//             ((r + 0.5) + dv) - 0.5, weights in float32 (warp_px in
//             stencils.cuh, shared with level.cu).
//
// Bound: device memory (read dh, dv and 3 gathered floats, write 3; the
// bilinear taps are neighbours of the nearest one and come from cache).  The
// TPU kernels exist because Mosaic has no 2-D gather: they sweep a
// source window per row tile and need a planner and an exact fallback
// for fields that leave the window.  A GPU thread can read any address,
// so one direct gather per output pixel is exact for every field and
// needs no window.  Coordinates are computed in float32 exactly as
// _dest_coords + tex_gather do, so the result is bit-exact.  Smooth
// fields keep neighbouring threads on neighbouring source addresses.
#include "stencils.cuh"

namespace {

constexpr int kThreads = 256;

template <bool BILINEAR>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ img, const float* __restrict__ dh,
                const float* __restrict__ dv, float* __restrict__ out, int C,
                int H, int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  for (int r = blockIdx.y; r < H; r += gridDim.y) {
    const size_t p = (size_t)r * W + x;
    ugsm::warp_px<BILINEAR>(img, out, C, H, W, r, x, dh[p], dv[p]);
  }
}

}  // namespace

// bilinear == 0: point sampling; != 0: CUDA linear filtering with float32
// weights (never the texture unit's 9-bit filter).
UGSM_API int ugsm_warp(const float* img, const float* dh, const float* dv,
                       float* out, int C, int H, int W, int bilinear,
                       void* stream) {
  if (C < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, H < 65535 ? H : 65535);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bilinear) {
    warp_kernel<true><<<grid, kThreads, 0, s>>>(img, dh, dv, out, C, H, W);
  } else {
    warp_kernel<false><<<grid, kThreads, 0, s>>>(img, dh, dv, out, C, H, W);
  }
  return (int)cudaGetLastError();
}

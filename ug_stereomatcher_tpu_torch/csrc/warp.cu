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
//
// Row-sharded form (warp_windowed / warp_windowed_dyn with row_halo=True,
// warp.py:356-385, :631-664): the output is a shard's rows [row0, row0 +
// Hl) of the level, from its own (Hl, W) disparity planes, and the source
// is the whole (C, H, W) right image of the level, gathered once per level
// by the caller; sources and clamps are in global rows.  The TPU form
// gathers from the shard's block plus a window of halo rows and needs the
// overflow guard when a field leaves it; the whole image needs neither.
#include "stencils.cuh"

namespace {

constexpr int kThreads = 256;

template <bool BILINEAR>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ img, const float* __restrict__ dh,
                const float* __restrict__ dv, float* __restrict__ out, int C,
                int H, int W, int Hl, int row0) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const size_t out_plane = (size_t)Hl * W;
  for (int r = blockIdx.y; r < Hl; r += gridDim.y) {
    const size_t p = (size_t)r * W + x;
    ugsm::warp_px<BILINEAR>(img, out, C, H, W, out_plane, p, row0 + r, x,
                            dh[p], dv[p]);
  }
}

}  // namespace

// img: (C, H, W); dh, dv, out: rows [row0, row0 + Hl) of the (H, W) grid
// (Hl = H, row0 = 0 for the whole image).  bilinear == 0: point sampling;
// != 0: CUDA linear filtering with float32 weights (never the texture
// unit's 9-bit filter).
UGSM_API int ugsm_warp(const float* img, const float* dh, const float* dv,
                       float* out, int C, int H, int W, int Hl, int row0,
                       int bilinear, void* stream) {
  if (C < 1 || H < 1 || W < 1 || Hl < 1 || row0 < 0 || row0 + Hl > H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, Hl < 65535 ? Hl : 65535);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bilinear) {
    warp_kernel<true><<<grid, kThreads, 0, s>>>(img, dh, dv, out, C, H, W, Hl,
                                                row0);
  } else {
    warp_kernel<false><<<grid, kThreads, 0, s>>>(img, dh, dv, out, C, H, W,
                                                 Hl, row0);
  }
  return (int)cudaGetLastError();
}

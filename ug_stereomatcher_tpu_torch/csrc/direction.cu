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
// because the shifted read needs it at clamped neighbours.  The tile body
// (direction_tile in stencils.cuh) is shared with level.cu.
#include "stencils.cuh"

namespace {

using ugsm::kDirBX;
using ugsm::kDirBY;

__global__ void __launch_bounds__(kDirBX * kDirBY)
    direction_kernel(const float* __restrict__ left,
                     const float* __restrict__ warped,
                     const float* __restrict__ bl2,
                     const float* __restrict__ bw2,
                     const float* __restrict__ disp, float* __restrict__ out,
                     int H, int W, float thr, int replace, ugsm::Taps5 taps,
                     ugsm::DirConsts k) {
  ugsm::direction_tile<ugsm::LdPlain>(left, warped, bl2, bw2, disp, out, H,
                                      W, blockIdx.y * kDirBY,
                                      blockIdx.x * kDirBX, thr, replace != 0,
                                      taps, k);
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
  if (H < 1 || W < 1 || (H + kDirBY - 1) / kDirBY > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ugsm::Taps5 taps =
      ugsm::make_taps5(t_outer, t_inner, t_centre, t_inner, t_outer);
  ugsm::launch_sep5(warped, bw2, 3, H, W, /*clamp=*/1, /*square=*/1, taps, s);
  const dim3 block(kDirBX, kDirBY);
  const dim3 grid((W + kDirBX - 1) / kDirBX, (H + kDirBY - 1) / kDirBY);
  const ugsm::DirConsts k{no_peak, aff_scale, aff_bias, w_new, w_old};
  direction_kernel<<<grid, block, 0, s>>>(left, warped, bl2, bw2, disp, out,
                                          H, W, threshold, replace, taps, k);
  return (int)cudaGetLastError();
}

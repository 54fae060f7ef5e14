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
//
// Row-sharded form (row_halo=True, direction.py:221-246): left and warped
// are a shard's rows with 3 real halo rows above and below, G(L^2) and
// the state are the shard's own Hl rows, and every boundary (the zero
// edge of the cross-product blur, the clamps of the shifted reads)
// resolves at global rows 0 and H - 1.  The TPU form needs 4 halo rows
// for its 8-row alignment; 3 (blur radius 2 + shift 1) is what the
// stencil reaches.  Gc(W^2) is computed over the haloed band, for the
// rows the shifted reads take (one per output row and one on each side),
// by the band form of the launch_sep5 kernel, which clamps at the
// image's global rows, so the band's edge never stands in for the
// image's.
#include "stencils.cuh"

namespace {

using ugsm::kDirBX;
using ugsm::kDirBY;

template <bool BAND>
__global__ void __launch_bounds__(kDirBX * kDirBY)
    direction_kernel(const float* __restrict__ left,
                     const float* __restrict__ warped,
                     const float* __restrict__ bl2,
                     const float* __restrict__ bw2,
                     const float* __restrict__ disp, float* __restrict__ out,
                     int H, int row0, int Hl, int halo, int W, float thr,
                     int replace, ugsm::Taps5 taps, ugsm::DirConsts k) {
  // Built here from ints, not passed in as a RowBlock: with the struct as
  // a kernel argument ptxas allocates the whole-image form differently,
  // and it ran 20 % slower on an H100 (PERF.md).
  const ugsm::RowBlock g =
      BAND ? ugsm::row_block(H, row0, Hl, halo) : ugsm::whole_image(H);
  ugsm::direction_tile<ugsm::LdPlain, BAND>(
      left, warped, bl2, bw2, disp, out, g, W, blockIdx.y * kDirBY,
      blockIdx.x * kDirBX, thr, replace != 0, taps, k);
}

}  // namespace

// Whole image: halo == 0, row0 == 0, Hl == H, every plane (3, H, W).
// Row-sharded: halo == 3; left, warped and the scratch bw2 are (3, Hl + 6,
// W), rows [row0 - 3, row0 + Hl + 3) of the H-row image; bl2, disp and out
// are (3, Hl, W).  Gaussian taps (t_outer, t_inner, t_centre); consts as
// MatcherConfig's (no_peak, affine_scale, affine_bias, blend_new,
// blend_old).
UGSM_API int ugsm_direction_update(const float* left, const float* warped,
                                   const float* bl2, const float* disp,
                                   float* bw2, float* out, int H, int W,
                                   int Hl, int row0, int halo,
                                   float threshold, int replace, float t_outer,
                                   float t_inner, float t_centre,
                                   float no_peak, float aff_scale,
                                   float aff_bias, float w_new, float w_old,
                                   void* stream) {
  const bool whole = halo == 0;
  if (H < 1 || W < 1 || Hl < 1 || (Hl + kDirBY - 1) / kDirBY > 65535 ||
      (whole ? (Hl != H || row0 != 0)
             : (halo != 3 || row0 < 0 || row0 + Hl > H)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ugsm::Taps5 taps =
      ugsm::make_taps5(t_outer, t_inner, t_centre, t_inner, t_outer);
  if (whole) {
    ugsm::launch_sep5(warped, bw2, 3, H, W, /*clamp=*/1, /*square=*/1, taps,
                      s);
  } else {
    // the global rows clamp(r + dy, 0, H - 1) of the shifted reads, r in
    // the shard, dy in -1 .. 1
    const int in_row0 = row0 - halo, in_rows = Hl + 2 * halo;
    const int lo = row0 > 0 ? row0 - 1 : 0;
    const int hi = row0 + Hl < H ? row0 + Hl + 1 : H;
    ugsm::launch_sep5_band(warped, bw2 + (size_t)(lo - in_row0) * W, 3, H, W,
                           in_row0, in_rows, lo, hi - lo, in_rows,
                           /*square=*/1, taps, s);
  }
  const dim3 block(kDirBX, kDirBY);
  const dim3 grid((W + kDirBX - 1) / kDirBX, (Hl + kDirBY - 1) / kDirBY);
  const ugsm::DirConsts k{no_peak, aff_scale, aff_bias, w_new, w_old};
  if (whole) {
    direction_kernel<false><<<grid, block, 0, s>>>(
        left, warped, bl2, bw2, disp, out, H, row0, Hl, halo, W, threshold,
        replace, taps, k);
  } else {
    direction_kernel<true><<<grid, block, 0, s>>>(
        left, warped, bl2, bw2, disp, out, H, row0, Hl, halo, W, threshold,
        replace, taps, k);
  }
  return (int)cudaGetLastError();
}

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
// Bound: device memory, 15 planes (read L, W, G(L^2) and the state, write
// the state; at 16 MP 0.288 ms at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 at 700 W).  The arithmetic is 436 float32 operations a pixel with
// no fused multiply-add, a floor of about 0.21 ms on the same card, so
// the kernel must keep every intermediate on the chip and spend few
// instructions besides the arithmetic.  Design (the tile body is in
// stencils.cuh, shared with level.cu):
// * a block of 64 x 4 threads owns a 16 x 64 output tile; it stages L
//   (the tile +- 2, zero outside the image) and W (the tile +- 3, clamped)
//   of all three channels with cp.async in one go, then computes Gc(W^2)
//   over the tile +- 1 from the staged W in two passes (row pass of W^2,
//   column pass), so no Gc(W^2) plane and no pre-pass exist;
// * each thread then owns 4 rows of one column and walks down them +- 2
//   rows per channel: the five moves' cross products and row passes from
//   L and three rows of W held in registers, and the column passes summed
//   as the rows arrive, so no cross product or row pass goes to shared
//   memory and the block meets at no barrier between moves or channels;
//   a warp reads 32 consecutive floats of one shared row (no bank
//   conflicts);
// * about 54 KB of dynamic shared memory and 80 registers a thread, three
//   blocks per SM.  Eight rows a thread (two blocks per SM, a larger
//   unrolled body) and four blocks per SM (spills) were slower (PERF.md).
//
// Row-sharded form (row_halo=True, direction.py:221-246): left and warped
// are a shard's rows with 3 real halo rows above and below, G(L^2) and the
// state are the shard's own Hl rows, and every boundary (the zero edge of
// the cross-product blur, the clamps of Gc(W^2) and of the shifted reads)
// resolves at global rows 0 and H - 1.  The TPU form needs 4 halo rows
// for its 8-row alignment; 3 (blur radius 2 + shift 1) is what the
// stencil reaches: Gc(W^2) of an output row's neighbours reads W rows
// within 3 of it, all in the band, so the in-tile Gc(W^2) serves this
// form too.
//
// Early-exit guard (stop not null; whole image only): every block returns
// before its first load while the flag is set (common.cuh stopped()).
#include "stencils.cuh"

namespace {

using Tile = ugsm::DirTile<64, 4, 4>;

// The tile, then Gc(W^2)'s row pass of one channel.
constexpr size_t kSmemBytes =
    sizeof(Tile) + sizeof(float) * Tile::WR * Tile::GC;

template <bool BAND>
__global__ void __launch_bounds__(Tile::kThreads, 3)
    direction_kernel(const float* __restrict__ left,
                     const float* __restrict__ warped,
                     const float* __restrict__ bl2,
                     const float* __restrict__ disp, float* __restrict__ out,
                     int H, int row0, int Hl, int halo, int W, float thr,
                     int replace, ugsm::Taps5 taps, ugsm::DirConsts k,
                     const int* __restrict__ stop) {
  if (ugsm::stopped(stop)) return;
  extern __shared__ float4 smem[];
  Tile& t = *reinterpret_cast<Tile*>(smem);
  float* rows = reinterpret_cast<float*>(smem) + sizeof(Tile) / sizeof(float);
  // Built here from ints, not passed in as a RowBlock: with the struct as
  // a kernel argument ptxas allocated the whole-image form differently,
  // and it ran 20 % slower on an NVIDIA H100 80GB HBM3 at 700 W
  // (PERF.md).
  const ugsm::RowBlock g =
      BAND ? ugsm::row_block(H, row0, Hl, halo) : ugsm::whole_image(H);
  const int r0 = blockIdx.y * Tile::kTH, c0 = blockIdx.x * Tile::kTW;
  const int grow0 = BAND ? row0 + r0 : r0;
  ugsm::direction_stage_left<BAND>(t, left, g, W, grow0, c0);
  ugsm::direction_stage_warped<BAND>(t, warped, g, W, grow0, c0);
  ugsm::cp_async_wait_all();
  __syncthreads();
  ugsm::direction_gw2<1>(t, rows, H, W, grow0, c0, taps);
  ugsm::direction_update_tile<ugsm::LdPlain, BAND, ugsm::LdPlain>(
      t, bl2, disp, out, g, W, r0, c0, thr, replace != 0, taps, k);
}

template <bool BAND>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* left,
                   const float* warped, const float* bl2, const float* disp,
                   float* out, int H, int row0, int Hl, int halo, int W,
                   float thr, int replace, ugsm::Taps5 taps,
                   ugsm::DirConsts k, const int* stop) {
  const cudaError_t e =
      cudaFuncSetAttribute(direction_kernel<BAND>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  direction_kernel<BAND><<<grid, dim3(Tile::kTW, Tile::kTH / Tile::kRows),
                           kSmemBytes, s>>>(left, warped, bl2, disp, out, H,
                                            row0, Hl, halo, W, thr, replace,
                                            taps, k, stop);
  return cudaGetLastError();
}

}  // namespace

// Whole image: halo == 0, row0 == 0, Hl == H, every plane (3, H, W).
// Row-sharded: halo == 3; left and warped are (3, Hl + 6, W), rows
// [row0 - 3, row0 + Hl + 3) of the H-row image; bl2, disp and out are
// (3, Hl, W).  Gaussian taps (t_outer, t_inner, t_centre), all nonzero;
// consts as MatcherConfig's (no_peak, affine_scale, affine_bias,
// blend_new, blend_old).  stop: the early-exit flag, or null.
UGSM_API int ugsm_direction_update(const float* left, const float* warped,
                                   const float* bl2, const float* disp,
                                   float* out, int H, int W, int Hl, int row0,
                                   int halo, float threshold, int replace,
                                   float t_outer, float t_inner,
                                   float t_centre, float no_peak,
                                   float aff_scale, float aff_bias,
                                   float w_new, float w_old,
                                   const int* stop, void* stream) {
  const bool whole = halo == 0;
  if (H < 1 || W < 1 || Hl < 1 || (Hl + Tile::kTH - 1) / Tile::kTH > 65535 ||
      t_outer == 0.0f || t_inner == 0.0f || t_centre == 0.0f ||
      (whole ? (Hl != H || row0 != 0)
             : (halo != 3 || row0 < 0 || row0 + Hl > H)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ugsm::Taps5 taps =
      ugsm::make_taps5(t_outer, t_inner, t_centre, t_inner, t_outer);
  const dim3 grid((W + Tile::kTW - 1) / Tile::kTW,
                  (Hl + Tile::kTH - 1) / Tile::kTH);
  const ugsm::DirConsts k{no_peak, aff_scale, aff_bias, w_new, w_old};
  return (int)(whole ? launch<false>(grid, s, left, warped, bl2, disp, out, H,
                                     row0, Hl, halo, W, threshold, replace,
                                     taps, k, stop)
                     : launch<true>(grid, s, left, warped, bl2, disp, out, H,
                                    row0, Hl, halo, W, threshold, replace,
                                    taps, k, stop));
}

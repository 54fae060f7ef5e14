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
//
// Row-sharded form (row_halo=True, smooth.py:48-110, :172-202): the input
// is a shard's state with n + 1 real halo rows on each side (the TPU form
// rounds that up to a multiple of 4 for its DMA alignment), the output
// its own Hl rows.  Each pass runs over the band's rows inside the image,
// with "keep row 0" and the clamps at the image's global edges; a pass
// spoils one more row at each edge of the band, so after n passes and
// the 3-tap average the Hl output rows are exact.  The average is the
// band form of the launch_sep5 kernel, clamped at the global edges.
#include "stencils.cuh"

namespace {

constexpr int kThreads = 256;

// One pass at band rows [lo, hi) (global rows g.in_row0 + lo ..).
__global__ void __launch_bounds__(kThreads)
    smooth_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                       ugsm::RowBlock g, int W, int lo, int hi) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  for (int i = lo + blockIdx.y; i < hi; i += gridDim.y) {
    ugsm::smooth_px<ugsm::LdPlain>(in, out, g, W, g.in_row0 + i, x);
  }
}

dim3 grid_for(int W, int rows) {
  return dim3((W + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
}

}  // namespace

// Whole image: halo == 0, row0 == 0, Hl == H; state, out, tmp_a, tmp_b
// (3, H, W).  Row-sharded: halo == n_passes + 1; state, tmp_a and tmp_b
// are (3, Hl + 2 halo, W), rows [row0 - halo, row0 + Hl + halo) of the
// H-row image; out is (3, Hl, W).
UGSM_API int ugsm_smooth_average(const float* state, float* out, float* tmp_a,
                                 float* tmp_b, int H, int W, int Hl, int row0,
                                 int halo, int n_passes, float avg_tap,
                                 void* stream) {
  const bool whole = halo == 0;
  if (H < 1 || W < 1 || Hl < 1 || n_passes < 0 ||
      (whole ? (Hl != H || row0 != 0)
             : (halo != n_passes + 1 || row0 < 0 || row0 + Hl > H)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ugsm::RowBlock g =
      whole ? ugsm::whole_image(H) : ugsm::row_block(H, row0, Hl, halo);
  // the band's rows inside the image
  const int lo = g.in_row0 < 0 ? -g.in_row0 : 0;
  const int hi = g.in_row0 + g.in_rows > H ? H - g.in_row0 : g.in_rows;
  const ugsm::Taps5 taps =
      ugsm::make_taps5(0.0f, avg_tap, avg_tap, avg_tap, 0.0f);
  const float* src = state;
  float* bufs[2] = {tmp_a, tmp_b};
  for (int i = 0; i < n_passes; ++i) {
    float* dst = bufs[i % 2];
    smooth_pass_kernel<<<grid_for(W, hi - lo), kThreads, 0, s>>>(src, dst, g,
                                                                 W, lo, hi);
    src = dst;
  }
  if (whole) {
    ugsm::launch_sep5(src, out, 3, H, W, /*clamp=*/1, taps, s);
  } else {
    ugsm::launch_sep5_band(src, out, 3, H, W, g.in_row0, g.in_rows, row0, Hl,
                           Hl, taps, s);
  }
  return (int)cudaGetLastError();
}

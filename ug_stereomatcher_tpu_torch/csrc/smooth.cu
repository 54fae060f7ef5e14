// Confidence-weighted smoothing chain: the Hopper form of
// fused_smooth_average (ug_stereomatcher_tpu/ops/pallas/smooth.py:165,
// pallas_call at :205).
//
// n passes of the plus-stencil weighted mean over (disp_h, disp_v, conf),
// each weighted by the confidence from before that pass, with clamp
// addressing; row 0 and column 0 keep their values (MatchLib.cu:1106).
// Then the separable 3-tap average with the literal 0.3333 taps and the
// clamp boundary.
//
// Bound: device memory, 3 planes read and 3 written once (at 16 MP 386
// MB, 0.115 ms at the 3.35 TB/s of an NVIDIA H100 80GB HBM3).  But each
// pass costs about 150 instructions a pixel (three IEEE divisions of
// about ten each, 13 shared loads, the window's addressing), so with the
// state on the chip the passes are bound by instruction issue, about
// 0.13 ms a pass at 16 MP, not by the bytes; a launch per pass moved the
// state 2n + 2 times through device memory and took as long.  Design: one
// launch runs a chunk of at most kMaxChunk passes and, in the last chunk,
// the average.  Each block loads its output tile plus a halo of k + 1
// lines (k for a chunk without the average) into shared memory once,
// runs the passes there (ping-pong, a pass spoils one more line at each
// side of the window that is not the image's edge; one pixel a thread in
// turn with no division per pixel: smooth_window_passes, shared with
// phase B of level.cu) and writes only its tile.  n <= kMaxChunk (the default configs' 5 and 10) is one
// launch with no scratch; a larger n runs ceil(n / kMaxChunk) launches
// through scratch states.  The per-pixel math is smooth_px_window and
// sep5_clamp_at (stencils.cuh), in the term order of ops/smooth.py
// (centre, left, right, up, down; num / den) and of the plain average,
// built with --fmad=false: bit-exact against the plain version.
//
// Row-sharded form (row_halo=True, smooth.py:48-110, :172-202): the input
// is a shard's state with n + 1 halo rows on each side (the TPU form
// rounds that up to a multiple of 4 for its DMA alignment), the output
// its own Hl rows.  The windows are clipped to the band's rows inside the
// image, "keep row 0" and the clamps resolve at the image's global rows,
// and a cut edge of the band spoils one line per pass as a window edge
// does, so after n passes and the average the Hl output rows are exact.
//
// Early-exit guard (stop not null): every block of every chunk returns
// before its first load while the flag is set (common.cuh stopped()), so
// `out` keeps what it held.
#include "stencils.cuh"

namespace {

// The output tile and the block: 32 threads along a row (a warp reads
// one window row), kTY rows of threads.  At 16 MP a 64 x 64 tile (its
// window of 10 passes about 1.8x its area, 177 KB, one block per SM) ran
// the 10 passes 8 % faster than 32 x 64 (two blocks per SM) and 5 passes
// as fast; 64 x 64 with 1024 threads and 32 x 64 with one block per SM
// were slower (PERF.md).
constexpr int kTH = 64, kTW = 64, kTY = 16;
constexpr int kThreads = 32 * kTY;
constexpr int kMaxChunk = 10;  // passes per launch; its window's size below

__host__ __device__ constexpr size_t window_bytes(int halo) {
  return 2 * 3 * (size_t)(kTH + 2 * halo) * (kTW + 2 * halo) * sizeof(float);
}

// One chunk over the tiles of the written rows [wr0, wr1): k passes and,
// under AVERAGE, the 3-tap average.  `in` holds in_rows rows from global
// row in_row0 (rows outside the image are never read); `out` holds
// out_rows rows from global row out_row0.
struct Chunk {
  const float* in;
  float* out;
  int H, W, in_row0, in_rows, out_row0, out_rows, wr0, wr1, k;
  ugsm::Taps5 avg;
  const int* stop;  // the early-exit flag, or null
};

template <bool AVERAGE>
__global__ void __launch_bounds__(kThreads)
    smooth_chunk_kernel(const Chunk a) {
  if (ugsm::stopped(a.stop)) return;
  extern __shared__ float win[];
  const int H = a.H, W = a.W, h = a.k + (AVERAGE ? 1 : 0);
  const int r0 = a.wr0 + blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int r1 = min(r0 + kTH, a.wr1), c1 = min(c0 + kTW, W);
  const int ra = max(r0 - h, max(a.in_row0, 0));
  const int rb = min(r0 + kTH + h, min(a.in_row0 + a.in_rows, H));
  const int ca = max(c0 - h, 0), cb = min(c0 + kTW + h, W);
  const int rw = cb - ca, wp = (rb - ra) * rw;
  const size_t iplane = (size_t)a.in_rows * W;
  for (int r = ra + (int)threadIdx.y; r < rb; r += kTY) {
    const float* src = a.in + (size_t)(r - a.in_row0) * W;
    float* dst = win + (r - ra) * rw - ca;
    for (int x = ca + (int)threadIdx.x; x < cb; x += 32) {
      for (int c = 0; c < 3; ++c) {
        ugsm::cp_async4(dst + c * wp + x, src + c * iplane + x, true);
      }
    }
  }
  ugsm::cp_async_wait_all();
  __syncthreads();
  const float* fin =
      ugsm::smooth_window_passes(win, wp, ra, rb, ca, cb, H, W, a.k);
  const size_t oplane = (size_t)a.out_rows * W;
  for (int r = r0 + (int)threadIdx.y; r < r1; r += kTY) {
    float* dst = a.out + (size_t)(r - a.out_row0) * W;
    for (int x = c0 + (int)threadIdx.x; x < c1; x += 32) {
      for (int c = 0; c < 3; ++c) {
        dst[c * oplane + x] =
            AVERAGE ? ugsm::sep5_clamp_at<false, 1>(
                          ugsm::PlaneAt<ugsm::LdPlain, int>{fin + c * wp, rw,
                                                            ra, ca},
                          r, x, H, W, a.avg)
                    : fin[c * wp + (r - ra) * rw + (x - ca)];
      }
    }
  }
}

// The shared memory limit is the largest window any launch asks for, the
// same for every launch: a launch captured in a CUDA graph never finds it
// lowered by a later eager launch with a smaller window.
template <bool AVERAGE>
cudaError_t launch_chunk(const Chunk& a, cudaStream_t s) {
  const size_t smem = window_bytes(a.k + (AVERAGE ? 1 : 0));
  cudaError_t e = cudaFuncSetAttribute(
      smooth_chunk_kernel<AVERAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)window_bytes(kMaxChunk + 1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(smooth_chunk_kernel<AVERAGE>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.wr1 - a.wr0 + kTH - 1) / kTH);
  smooth_chunk_kernel<AVERAGE><<<grid, dim3(32, kTY), smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The passes one launch runs (the state goes through scratch between
// launches when n_passes is larger).
UGSM_API int ugsm_smooth_max_chunk() { return kMaxChunk; }

// Whole image: halo == 0, row0 == 0, Hl == H; state and out (3, H, W).
// Row-sharded: halo == n_passes + 1; state is (3, Hl + 2 halo, W), rows
// [row0 - halo, row0 + Hl + halo) of the H-row image; out is (3, Hl, W).
// tmp_a (with n_passes > kMaxChunk) and tmp_b (with n_passes > 2
// kMaxChunk) are scratch states of the shape of `state`; null otherwise.
// stop: the early-exit flag, or null.
UGSM_API int ugsm_smooth_average(const float* state, float* out, float* tmp_a,
                                 float* tmp_b, int H, int W, int Hl, int row0,
                                 int halo, int n_passes, float avg_tap,
                                 const int* stop, void* stream) {
  const bool whole = halo == 0;
  if (H < 1 || W < 1 || Hl < 1 || n_passes < 0 || avg_tap == 0.0f ||
      (whole ? (Hl != H || row0 != 0)
             : (halo != n_passes + 1 || row0 < 0 || row0 + Hl > H)) ||
      (n_passes > kMaxChunk && tmp_a == nullptr) ||
      (n_passes > 2 * kMaxChunk && tmp_b == nullptr) ||
      (Hl + 2LL * halo + kTH) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int in_row0 = row0 - halo, in_rows = Hl + 2 * halo;
  // the band's rows inside the image, which an intermediate chunk writes
  const int lo = in_row0 > 0 ? in_row0 : 0;
  const int hi = in_row0 + in_rows < H ? in_row0 + in_rows : H;
  Chunk a{state, nullptr, H, W, in_row0, in_rows, in_row0, in_rows,
          lo, hi, kMaxChunk,
          ugsm::make_taps5(0.0f, avg_tap, avg_tap, avg_tap, 0.0f), stop};
  float* tmp[2] = {tmp_a, tmp_b};
  int left = n_passes;
  for (int i = 0; left > kMaxChunk; ++i, left -= kMaxChunk) {
    a.out = tmp[i & 1];
    const cudaError_t e = launch_chunk<false>(a, s);
    if (e != cudaSuccess) return (int)e;
    a.in = a.out;
  }
  a.out = out;
  a.out_row0 = row0;
  a.out_rows = Hl;
  a.wr0 = row0;
  a.wr1 = row0 + Hl;
  a.k = left;
  return (int)launch_chunk<true>(a, s);
}

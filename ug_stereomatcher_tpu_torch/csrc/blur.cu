// Separable 5-tap blur: the Hopper form of fused_blur_gaussian
// (ug_stereomatcher_tpu/ops/pallas/blur.py:120, pallas_call at :150).
//
// Bound: device memory.  A blur reads and writes each float once (the
// 16 MP stacked pyramid level is 386 MB each way, 0.230 ms at the 3.35
// TB/s of an NVIDIA H100 80GB HBM3) and does 18 float32 operations a
// pixel, far below the card's operations-per-byte line.  So the kernel
// must keep enough loads in flight and spend few instructions on
// anything but the loads and the 18 operations.  Design: each warp owns
// a strip of 128 columns of one plane (4 consecutive columns a lane) and
// walks it down a run of rows, so the vertical halo (2 rows above and
// below the run) is read once per run and no shared memory or barrier is
// used:
// * a row comes in as one 16-byte load a lane (4-byte loads where the
//   rows are not 16-byte aligned); the +-2 columns come from the
//   neighbouring lanes by warp shuffles, and the strip's lanes 0 and 31
//   load the two columns beyond the strip themselves;
// * the row pass of the lane's 4 columns is computed in registers, and
//   the column pass from a rolling window of the last 5 row-pass rows in
//   registers; the next row's loads are issued before this row's
//   arithmetic;
// * strips and runs whose reads lie inside the image take a form with no
//   boundary selects; the others apply the boundary per pass as jnp.pad
//   does inside conv1d: zeros outside the image (zero) or the clamped
//   neighbour (clamp), for the row pass on the input and for the column
//   pass on the row-pass rows;
// * the runs are shortened on small images, down to 16 rows, so that
//   several planes and runs keep the card's SMs busy.
// Every output is pass5_all of the row-pass values, each of those
// pass5_all of the inputs: the terms and order of the plain version
// (ops/conv.py conv_separable), built with --fmad=false, so the result is
// bit-exact against it.  The taps must all be nonzero (the plain version
// skips a zero tap; the Gaussian has none).
#include <stdint.h>

#include "common.cuh"

namespace {

using ugsm::clampi;
using ugsm::pass5_all;
using ugsm::Taps5;

constexpr int kWarps = 4;            // warps per block, each on its own strip
constexpr int kStrip = 128;          // columns per strip: 4 per lane
constexpr int kMinRun = 16, kMaxRun = 64;  // rows per run
constexpr int kTargetWarps = 132 * 32;     // enough to fill an H100
constexpr unsigned kFull = 0xffffffffu;

// One input row at global row i for the lane's columns c0 .. c0 + 3 (v)
// and, for lanes 0 and 31, the two columns beyond the strip (e: c0 - 2,
// c0 - 1 or c0 + 4, c0 + 5), with the boundary (EDGE) or without it
// (every read inside the image).
template <bool CLAMP, bool EDGE, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ xp, int H,
                                         int W, int i, int c0, int lane,
                                         float (&v)[4], float (&e)[2]) {
  const bool rowok = !EDGE || CLAMP || (i >= 0 && i < H);
  const int ri = EDGE && CLAMP ? clampi(i, 0, H - 1) : i;
  const float* row = xp + (size_t)(rowok ? ri : 0) * W;
  auto at = [&](int c) -> float {
    if (!EDGE) return row[c];
    if (CLAMP) return row[clampi(c, 0, W - 1)];
    return rowok && c >= 0 && c < W ? row[c] : 0.0f;
  };
  if (VEC && rowok && (!EDGE || c0 + 3 < W)) {
    const float4 t = *reinterpret_cast<const float4*>(row + c0);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = at(c0 + j);
  }
  if (lane == 0 || lane == 31) {
    const int ec = lane == 0 ? c0 - 2 : c0 + 4;
    e[0] = at(ec);
    e[1] = at(ec + 1);
  }
}

// The warp's strip of plane xp / op: columns from the warp's first column
// s0, output rows [r0, r1).
template <bool CLAMP, bool EDGE, bool VEC>
__device__ __forceinline__ void blur_strip(const float* __restrict__ xp,
                                           float* __restrict__ op, int H,
                                           int W, int r0, int r1, int s0,
                                           const Taps5& tp) {
  const int lane = threadIdx.x & 31;
  const int c0 = s0 + 4 * lane;
  float v[4], e[2] = {0.0f, 0.0f};
  float q[5][4] = {};  // row-pass rows i - 4 .. i
  load_row<CLAMP, EDGE, VEC>(xp, H, W, r0 - 2, c0, lane, v, e);
  for (int i = r0 - 2; i < r1 + 2; ++i) {
    float w[8];  // columns c0 - 2 .. c0 + 5 of row i
    const float a = __shfl_up_sync(kFull, v[2], 1);
    const float b = __shfl_up_sync(kFull, v[3], 1);
    const float c = __shfl_down_sync(kFull, v[0], 1);
    const float d = __shfl_down_sync(kFull, v[1], 1);
    w[0] = lane == 0 ? e[0] : a;
    w[1] = lane == 0 ? e[1] : b;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[2 + j] = v[j];
    w[6] = lane == 31 ? e[0] : c;
    w[7] = lane == 31 ? e[1] : d;
    if (i + 1 < r1 + 2) {
      load_row<CLAMP, EDGE, VEC>(xp, H, W, i + 1, c0, lane, v, e);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k][j] = q[k + 1][j];
      q[4][j] = pass5_all(tp, w[j], w[j + 1], w[j + 2], w[j + 3], w[j + 4]);
    }
    if (i < r0 + 2) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = pass5_all(tp, q[0][j], q[1][j], q[2][j], q[3][j], q[4][j]);
    }
    float* orow = op + (size_t)(i - 2) * W;
    if (VEC && (!EDGE || c0 + 3 < W)) {
      *reinterpret_cast<float4*>(orow + c0) = make_float4(o[0], o[1], o[2],
                                                          o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!EDGE || c0 + j < W) orow[c0 + j] = o[j];
      }
    }
  }
}

// Warp g of the grid takes strip g % strips of run (g / strips) % runs of
// plane g / (strips * runs).
template <bool CLAMP, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    blur5_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
                 int H, int W, int strips, int runs, int run_rows,
                 Taps5 tp) {
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= (long long)C * runs * strips) return;  // whole warps only
  const int strip = (int)(g % strips);
  const int run = (int)((g / strips) % runs);
  const int plane = (int)(g / ((long long)strips * runs));
  const size_t off = (size_t)plane * H * W;
  const int s0 = strip * kStrip;
  const int r0 = run * run_rows, r1 = min(r0 + run_rows, H);
  const bool edge = s0 < 2 || s0 + kStrip + 2 > W || r0 < 2 || r1 + 2 > H;
  if (edge) {
    blur_strip<CLAMP, true, VEC>(x + off, out + off, H, W, r0, r1, s0, tp);
  } else {
    blur_strip<CLAMP, false, VEC>(x + off, out + off, H, W, r0, r1, s0, tp);
  }
}

template <bool CLAMP>
void launch(const float* x, float* out, int C, int H, int W, bool vec,
            const Taps5& tp, cudaStream_t s) {
  const int strips = (W + kStrip - 1) / kStrip;
  const long long want = ((long long)C * strips * H + kTargetWarps - 1) /
                         kTargetWarps;
  const int run_rows =
      (int)(want < kMinRun ? kMinRun : (want > kMaxRun ? kMaxRun : want));
  const int runs = (H + run_rows - 1) / run_rows;
  const long long warps = (long long)C * runs * strips;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  if (vec) {
    blur5_kernel<CLAMP, true><<<blocks, 32 * kWarps, 0, s>>>(
        x, out, C, H, W, strips, runs, run_rows, tp);
  } else {
    blur5_kernel<CLAMP, false><<<blocks, 32 * kWarps, 0, s>>>(
        x, out, C, H, W, strips, runs, run_rows, tp);
  }
}

}  // namespace

// Separable 5-tap blur of C planes (H, W): row pass, then column pass,
// zero (clamp == 0) or clamp boundary per pass; t0 .. t4 in conv1d
// storage (the weight at offset k is t[2 - k]), all nonzero.
UGSM_API int ugsm_sep5(const float* x, float* out, int C, int H, int W,
                       int clamp, float t0, float t1, float t2, float t3,
                       float t4, void* stream) {
  if (C < 1 || H < 1 || W < 1 || (long long)C * H * W > (1LL << 40) ||
      t0 == 0.0f || t1 == 0.0f || t2 == 0.0f || t3 == 0.0f || t4 == 0.0f)
    return (int)cudaErrorInvalidValue;
  const bool vec =
      W % 4 == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const Taps5 tp = ugsm::make_taps5(t0, t1, t2, t3, t4);
  const cudaStream_t s = (cudaStream_t)stream;
  if (clamp) {
    launch<true>(x, out, C, H, W, vec, tp, s);
  } else {
    launch<false>(x, out, C, H, W, vec, tp, s);
  }
  return (int)cudaGetLastError();
}

UGSM_API const char* ugsm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

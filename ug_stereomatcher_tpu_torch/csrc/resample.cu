// Separable resample from host index vectors: the Hopper form of
// resample_static / resample_tex (ug_stereomatcher_tpu/ops/pallas/
// resample.py), nearest and bilinear.
//
//   nearest:  out[c, r, x] = s * img[c, iy[r], ix[x]]
//   bilinear: a_k = img[c, iy[r], k] * (1 - wy[r]) + img[c, iy[r] + 1, k] * wy[r]
//             at k = ix[x], ix[x] + 1 (the + 1 taps clamped to the image),
//             out = s * (a_ix * (1 - wx[x]) + a_ix+1 * wx[x])
//   with the floor taps and float32 weights computed on the host in
//   float64 (ops/resample.py bilinear_taps); rows interpolate before
//   columns, as the TPU kernel's two-hot row matrix does.
//
// Bound: device memory; it is a pure gather (each output written once,
// each source texel the taps reach read once).  The TPU version turns the
// selection into one-hot matmuls because its vector unit cannot gather;
// here threads read their source floats directly.
//
// Nearest: with one output per thread (a block per 256-column run of one
// row and one plane, about 194 K blocks at the sqrt(2) subsample of six
// 16 MP planes) each thread makes two index loads, one gather and one
// store, reuses no index and has one load in flight, and the kernel loses
// to one F.interpolate call on an H100.  So each thread owns kCols
// columns 32 apart (each store of a warp is one coalesced run of 32
// floats, whatever the row's alignment: W2 is odd on most levels, and no
// vector store is issued) and a strip of kRows rows; it loads its ix once
// and the strip's iy once, keeps them in registers across the rows and
// every plane, and issues the kRows * kCols gathers of a plane before
// their stores.  The grid is a block of kWarps warps per 32 * kCols
// columns and kWarps * kRows rows, about two waves of the SMs at 16 MP.
//
// Bilinear: a block covers 256 consecutive output columns of one row and
// one plane, so the writes are coalesced and the reads of one warp fall
// into a span of about 32 * scale floats of one source row; wy/iy are the
// same for the block, ix/wx read through the read-only cache.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;   // nearest: columns per thread, 32 apart
constexpr int kRows = 4;   // nearest: rows per warp strip
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ img, float* __restrict__ out,
                    const int* __restrict__ iy, const int* __restrict__ ix,
                    int C, int H, int W, int H2, int W2, float scale,
                    int apply) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * (32 * kCols) + lane;
  int sx[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int x = x0 + 32 * k;
    sx[k] = x < W2 ? __ldg(ix + x) : 0;
  }
  for (int r0 = (blockIdx.y * kWarps + warp) * kRows; r0 < H2;
       r0 += gridDim.y * kWarps * kRows) {
    int sy[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      sy[i] = __ldg(iy + (r0 + i < H2 ? r0 + i : H2 - 1));
    }
    for (int c = 0; c < C; ++c) {
      const float* __restrict__ src = img + (size_t)c * H * W;
      float* __restrict__ dst = out + (size_t)c * H2 * W2;
      float v[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          v[i][k] = __ldg(src + (size_t)sy[i] * W + sx[k]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (r0 + i >= H2) break;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int x = x0 + 32 * k;
          if (x < W2) {
            dst[(size_t)(r0 + i) * W2 + x] = apply ? scale * v[i][k] : v[i][k];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    resample_bilinear_kernel(const float* __restrict__ img,
                             float* __restrict__ out,
                             const int* __restrict__ iy,
                             const int* __restrict__ ix,
                             const float* __restrict__ wy,
                             const float* __restrict__ wx, int H, int W,
                             int H2, int W2, float scale, int apply) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W2) return;
  const int c = blockIdx.z;
  const int sx0 = __ldg(ix + x);
  const int sx1 = sx0 + 1 < W ? sx0 + 1 : W - 1;
  const float ax = __ldg(wx + x);
  for (int r = blockIdx.y; r < H2; r += gridDim.y) {
    const int sy0 = __ldg(iy + r);
    const int sy1 = sy0 + 1 < H ? sy0 + 1 : H - 1;
    const float ay = __ldg(wy + r);
    const float* __restrict__ p0 = img + ((size_t)c * H + sy0) * W;
    const float* __restrict__ p1 = img + ((size_t)c * H + sy1) * W;
    const float a0 = p0[sx0] * (1.0f - ay) + p1[sx0] * ay;
    const float a1 = p0[sx1] * (1.0f - ay) + p1[sx1] * ay;
    const float v = a0 * (1.0f - ax) + a1 * ax;
    out[((size_t)c * H2 + r) * W2 + x] = apply ? scale * v : v;
  }
}

}  // namespace

UGSM_API int ugsm_resample_nearest(const float* img, float* out,
                                   const int* iy, const int* ix, int C, int H,
                                   int W, int H2, int W2, float scale,
                                   int apply, void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1 || H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  const int strips = (H2 + kWarps * kRows - 1) / (kWarps * kRows);
  const dim3 grid((W2 + 32 * kCols - 1) / (32 * kCols),
                  strips < 65535 ? strips : 65535);
  resample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, out, iy, ix, C, H, W, H2, W2, scale, apply);
  return (int)cudaGetLastError();
}

// iy/ix: floor taps in range; wy/wx: their float32 weights (device).
UGSM_API int ugsm_resample_bilinear(const float* img, float* out,
                                    const int* iy, const int* ix,
                                    const float* wy, const float* wx, int C,
                                    int H, int W, int H2, int W2,
                                    float scale, int apply, void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1 || H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W2 + kThreads - 1) / kThreads, H2 < 65535 ? H2 : 65535, C);
  resample_bilinear_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, out, iy, ix, wy, wx, H, W, H2, W2, scale, apply);
  return (int)cudaGetLastError();
}

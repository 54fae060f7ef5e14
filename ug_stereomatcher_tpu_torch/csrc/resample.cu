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
// Bound: device memory; it is a pure gather.  The TPU version turns the
// selection into one-hot matmuls because its vector unit cannot gather;
// here one thread reads one source float.  Design: a block covers 256
// consecutive output columns of one row and one plane, so the writes are
// coalesced and the reads of one warp fall into a span of about
// 32 * scale floats of one source row.  iy[r] is the same for the block;
// ix is read through the read-only cache.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ img, float* __restrict__ out,
                    const int* __restrict__ iy, const int* __restrict__ ix,
                    int H, int W, int H2, int W2, float scale, int apply) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W2) return;
  const int c = blockIdx.z;
  const int sx = __ldg(ix + x);
  for (int r = blockIdx.y; r < H2; r += gridDim.y) {
    const float v = img[((size_t)c * H + __ldg(iy + r)) * W + sx];
    out[((size_t)c * H2 + r) * W2 + x] = apply ? scale * v : v;
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
  const dim3 grid((W2 + kThreads - 1) / kThreads, H2 < 65535 ? H2 : 65535, C);
  resample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, out, iy, ix, H, W, H2, W2, scale, apply);
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

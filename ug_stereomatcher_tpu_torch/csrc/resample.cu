// Separable nearest resample from host index vectors: the Hopper form of
// resample_static / resample_tex (ug_stereomatcher_tpu/ops/pallas/
// resample.py), out[c, r, x] = s * img[c, iy[r], ix[x]].
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

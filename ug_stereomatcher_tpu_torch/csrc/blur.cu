// Separable 5-tap blur: the Hopper form of fused_blur_gaussian
// (ug_stereomatcher_tpu/ops/pallas/blur.py).
//
// Bound: device memory.  A blur reads and writes each float once (the
// 16 MP stacked pyramid level is 386 MB each way) and does 20 flops per
// pixel, far below the card's flop-per-byte line.  Design: one block per
// 32 x 32 output tile; the tile and its 2-pixel halo come into shared
// memory once, coalesced (a warp reads one 32-float row), the row pass
// writes a (32 + 4) x 32 intermediate to shared memory and the column pass
// reads it from there, so neither the padded input nor the row-pass plane
// goes through device memory.  The boundary is applied per pass exactly
// as jnp.pad does inside conv1d: zeros outside the image (zero) or the
// clamped neighbour (clamp).
#include "common.cuh"

namespace ugsm {
namespace {

constexpr int kBX = 32;  // tile width = threads in x
constexpr int kBY = 8;   // threads in y
constexpr int kTH = 32;  // tile height (4 rows per thread)

template <bool CLAMP, bool SQUARE>
__global__ void __launch_bounds__(kBX * kBY)
    sep5_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
                int W, Taps5 taps) {
  __shared__ float xs[kTH + 4][kBX + 4];
  __shared__ float rs[kTH + 4][kBX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kBX, r0 = blockIdx.y * kTH;
  const size_t plane = (size_t)H * W;
  const float* __restrict__ xp = x + (size_t)blockIdx.z * plane;
  float* __restrict__ op = out + (size_t)blockIdx.z * plane;

  for (int i = ty; i < kTH + 4; i += kBY) {
    const int gr = r0 - 2 + i;
    for (int j = tx; j < kBX + 4; j += kBX) {
      const int gc = c0 - 2 + j;
      float v;
      if (CLAMP) {
        v = xp[(size_t)clampi(gr, 0, H - 1) * W + clampi(gc, 0, W - 1)];
      } else {
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
        v = inside ? xp[(size_t)gr * W + gc] : 0.0f;
      }
      if (SQUARE) v = v * v;
      xs[i][j] = v;
    }
  }
  __syncthreads();

  // Row pass over every staged row.  A row outside the image is the
  // clamped edge row (clamp) or all zeros (zero), so its row-pass value
  // is what the column pass's own padding would supply.
  for (int i = ty; i < kTH + 4; i += kBY) {
    rs[i][tx] = pass5(taps, xs[i][tx], xs[i][tx + 1], xs[i][tx + 2],
                      xs[i][tx + 3], xs[i][tx + 4]);
  }
  __syncthreads();

  const int gc = c0 + tx;
  if (gc >= W) return;
  for (int i = ty; i < kTH; i += kBY) {
    const int gr = r0 + i;
    if (gr >= H) break;
    op[(size_t)gr * W + gc] = pass5(taps, rs[i][tx], rs[i + 1][tx],
                                    rs[i + 2][tx], rs[i + 3][tx],
                                    rs[i + 4][tx]);
  }
}

}  // namespace

void launch_sep5(const float* x, float* out, int C, int H, int W, int clamp,
                 int square, Taps5 taps, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kTH - 1) / kTH, C);
  if (clamp) {
    if (square) {
      sep5_kernel<true, true><<<grid, block, 0, stream>>>(x, out, H, W, taps);
    } else {
      sep5_kernel<true, false><<<grid, block, 0, stream>>>(x, out, H, W, taps);
    }
  } else {
    if (square) {
      sep5_kernel<false, true><<<grid, block, 0, stream>>>(x, out, H, W, taps);
    } else {
      sep5_kernel<false, false><<<grid, block, 0, stream>>>(x, out, H, W,
                                                           taps);
    }
  }
}

}  // namespace ugsm

UGSM_API int ugsm_sep5(const float* x, float* out, int C, int H, int W,
                       int clamp, float t0, float t1, float t2, float t3,
                       float t4, void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  ugsm::launch_sep5(x, out, C, H, W, clamp, /*square=*/0,
                    ugsm::make_taps5(t0, t1, t2, t3, t4),
                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

UGSM_API const char* ugsm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

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

// BAND (clamp boundary only): x holds x_rows rows of the H-row image
// from global row x_row0, and the kernel writes out_rows rows from global
// row out_row0 into planes of out_plane_rows rows.  Rows clamp at the
// image's global edges, so the band's rows equal the whole image's; a
// staged row past the band (read only by a tile row past out_rows) is
// clamped to the band.
template <bool CLAMP, bool BAND>
__global__ void __launch_bounds__(kBX * kBY)
    sep5_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
                int W, Taps5 taps, int x_row0, int x_rows, int out_row0,
                int out_rows, int out_plane_rows) {
  __shared__ float xs[kTH + 4][kBX + 4];
  __shared__ float rs[kTH + 4][kBX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kBX, r0 = blockIdx.y * kTH;
  const int rows = BAND ? out_rows : H;
  const int grow0 = BAND ? out_row0 + r0 : r0;  // global row of the tile
  const size_t xplane = (size_t)(BAND ? x_rows : H) * W;
  const size_t oplane = (size_t)(BAND ? out_plane_rows : H) * W;
  const float* __restrict__ xp = x + (size_t)blockIdx.z * xplane;
  float* __restrict__ op = out + (size_t)blockIdx.z * oplane;

  for (int i = ty; i < kTH + 4; i += kBY) {
    const int gr = grow0 - 2 + i;
    for (int j = tx; j < kBX + 4; j += kBX) {
      const int gc = c0 - 2 + j;
      float v;
      if (CLAMP) {
        int lr = clampi(gr, 0, H - 1);
        if (BAND) lr = clampi(lr - x_row0, 0, x_rows - 1);
        v = xp[(size_t)lr * W + clampi(gc, 0, W - 1)];
      } else {
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
        v = inside ? xp[(size_t)gr * W + gc] : 0.0f;
      }
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
    const int r = r0 + i;
    if (r >= rows) break;
    op[(size_t)r * W + gc] = pass5(taps, rs[i][tx], rs[i + 1][tx],
                                   rs[i + 2][tx], rs[i + 3][tx],
                                   rs[i + 4][tx]);
  }
}

}  // namespace

void launch_sep5(const float* x, float* out, int C, int H, int W, int clamp,
                 Taps5 taps, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kTH - 1) / kTH, C);
  if (clamp) {
    sep5_kernel<true, false>
        <<<grid, block, 0, stream>>>(x, out, H, W, taps, 0, H, 0, H, H);
  } else {
    sep5_kernel<false, false>
        <<<grid, block, 0, stream>>>(x, out, H, W, taps, 0, H, 0, H, H);
  }
}

void launch_sep5_band(const float* x, float* out, int C, int H, int W,
                      int x_row0, int x_rows, int out_row0, int out_rows,
                      int out_plane_rows, Taps5 taps, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (out_rows + kTH - 1) / kTH, C);
  sep5_kernel<true, true><<<grid, block, 0, stream>>>(
      x, out, H, W, taps, x_row0, x_rows, out_row0, out_rows, out_plane_rows);
}

}  // namespace ugsm

UGSM_API int ugsm_sep5(const float* x, float* out, int C, int H, int W,
                       int clamp, float t0, float t1, float t2, float t3,
                       float t4, void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  ugsm::launch_sep5(x, out, C, H, W, clamp,
                    ugsm::make_taps5(t0, t1, t2, t3, t4),
                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

UGSM_API const char* ugsm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

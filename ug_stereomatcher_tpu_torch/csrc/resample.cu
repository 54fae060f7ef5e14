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
// Bilinear replaces resample_static (pallas/resample.py:137, pallas_call at
// :223) with wy/wx, reached through resample_tex (:286) with the taps of
// _bilinear_taps (:261).  The TPU kernel's two-hot row matrix and one-hot
// column matmuls (:101-133) exist only because Mosaic cannot gather; none of
// that is carried over.  Bound by bytes: at the 16 MP upsample (3 x 2307 x
// 3484 -> 3264 x 4928) 96 MB in and 193 MB out.  The first form gave each
// thread one output: eight loads (ix, wx, iy, wy, then four dependent
// gathers) for one 4-byte store, one chain in flight, no tap reused, about
// 196 K blocks, 31-35 % of the bound.  Here the layout is the nearest
// kernel's: each thread owns kCols columns 32 apart (each warp store one
// coalesced run) and a warp a strip of R consecutive output rows (R = 4, 2
// or 1).  A thread loads (ix, ix + 1, wx) for its columns once a block and
// (iy, iy + 1, wy) for its strip once, and keeps them in registers across
// the strip and the block's planes (the plane loop is inside the block).
// Each output row issues its 4 * kCols gathers, independent of each other,
// before its stores; issuing all of a plane's strip first, as the nearest
// kernel does, ran 1-3 % slower at 16 MP and 10-16 % on the small cases
// (PERF.md).  Source rows that repeat between the rows of a strip (the
// upsample's 1/sqrt(2) ratio gives 4 output rows about 3 source rows) are
// read again through L1, where the warp has just fetched them, so device
// memory sees each once: on an H100 this ran 5-11 % faster than keeping the
// strip's source rows in registers and reusing them where the taps repeat,
// whose warp-uniform test put every row's loads behind a branch (PERF.md). A
// shared-memory band would add a store, a barrier and a shared load a texel
// to what L1 does here; it was not built.  Strips of 8 rows took 113-128
// registers in the forms tried and ran the upsample 8-18 % slower than
// strips of 4. The host sizes the grid to the output (ops/cuda/resample.py
// bilinear_launch): the strip height, then the planes a block takes, then
// the warps a block has, fall until the grid holds two blocks an SM, so
// small levels, the range map and the fovea window fill the card too.
// Offsets are 32-bit: the wrapper refuses planes past 2^31 floats.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;   // columns per thread, 32 apart
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

// The source texels of a thread's kCols columns on one source row: at the
// floor tap and at its clamped neighbour.
__device__ __forceinline__ void load_taps(const float* __restrict__ row,
                                          const int (&sx0)[kCols],
                                          const int (&sx1)[kCols],
                                          float (&v0)[kCols],
                                          float (&v1)[kCols]) {
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    v0[k] = __ldg(row + sx0[k]);
    v1[k] = __ldg(row + sx1[k]);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    resample_bilinear_kernel(const float* __restrict__ img,
                             float* __restrict__ out,
                             const int* __restrict__ iy,
                             const int* __restrict__ ix,
                             const float* __restrict__ wy,
                             const float* __restrict__ wx, int C, int H,
                             int W, int H2, int W2, int planes, float scale,
                             int apply) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int x0 = blockIdx.x * (32 * kCols) + lane;
  int sx0[kCols], sx1[kCols];
  float ax[kCols], bx[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int x = min(x0 + 32 * k, W2 - 1);
    sx0[k] = __ldg(ix + x);
    sx1[k] = min(sx0[k] + 1, W - 1);
    ax[k] = __ldg(wx + x);
    bx[k] = 1.0f - ax[k];
  }
  const int c0 = blockIdx.z * planes;
  const int c1 = min(c0 + planes, C);
  for (int r0 = (blockIdx.y * warps + warp) * R; r0 < H2;
       r0 += gridDim.y * warps * R) {
    int sy0[R], sy1[R];
    float ay[R], by[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = min(r0 + i, H2 - 1);
      sy0[i] = __ldg(iy + r);
      sy1[i] = min(sy0[i] + 1, H - 1);
      ay[i] = __ldg(wy + r);
      by[i] = 1.0f - ay[i];
    }
    for (int c = c0; c < c1; ++c) {
      const float* __restrict__ src = img + c * H * W;
      float* __restrict__ dst = out + c * H2 * W2;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (r0 + i >= H2) break;  // uniform across the warp
        // t*: source row sy0, u*: source row sy1; *0 at sx0, *1 at sx1
        float t0[kCols], t1[kCols], u0[kCols], u1[kCols];
        load_taps(src + sy0[i] * W, sx0, sx1, t0, t1);
        load_taps(src + sy1[i] * W, sx0, sx1, u0, u1);
        float* __restrict__ row = dst + (r0 + i) * W2;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float a0 = t0[k] * by[i] + u0[k] * ay[i];
          const float a1 = t1[k] * by[i] + u1[k] * ay[i];
          const float v = a0 * bx[k] + a1 * ax[k];
          if (x0 + 32 * k < W2) row[x0 + 32 * k] = apply ? scale * v : v;
        }
      }
    }
  }
}

template <int R>
void launch_bilinear(dim3 grid, int warps, cudaStream_t s, const float* img,
                     float* out, const int* iy, const int* ix,
                     const float* wy, const float* wx, int C, int H, int W,
                     int H2, int W2, int planes, float scale, int apply) {
  resample_bilinear_kernel<R><<<grid, 32 * warps, 0, s>>>(
      img, out, iy, ix, wy, wx, C, H, W, H2, W2, planes, scale, apply);
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
// rows (1, 2 or 4), planes (1..C) and warps (1, 2, 4 or 8): the strip
// height, the planes a block takes and the warps a block has, chosen by
// the host from the output (ops/cuda/resample.py bilinear_launch).
UGSM_API int ugsm_resample_bilinear(const float* img, float* out,
                                    const int* iy, const int* ix,
                                    const float* wy, const float* wx, int C,
                                    int H, int W, int H2, int W2,
                                    float scale, int apply, int rows,
                                    int planes, int warps, void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1 || H2 < 1 || W2 < 1 ||
      (long long)C * H * W > INT_MAX || (long long)C * H2 * W2 > INT_MAX ||
      planes < 1 || planes > C || warps < 1 || warps > kWarps ||
      (warps & (warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int strips = (H2 + warps * rows - 1) / (warps * rows);
  const dim3 grid((W2 + 32 * kCols - 1) / (32 * kCols),
                  strips < 65535 ? strips : 65535,
                  (C + planes - 1) / planes);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1:
      launch_bilinear<1>(grid, warps, s, img, out, iy, ix, wy, wx, C, H, W,
                         H2, W2, planes, scale, apply);
      break;
    case 2:
      launch_bilinear<2>(grid, warps, s, img, out, iy, ix, wy, wx, C, H, W,
                         H2, W2, planes, scale, apply);
      break;
    case 4:
      launch_bilinear<4>(grid, warps, s, img, out, iy, ix, wy, wx, C, H, W,
                         H2, W2, planes, scale, apply);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

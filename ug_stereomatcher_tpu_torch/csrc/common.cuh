// Shared helpers of the port's CUDA kernels.
//
// Built with --fmad=false: every multiply and add below rounds on its
// own, in the order written, which is the order of the plain PyTorch
// versions (ops/conv.py conv1d: weight kernel[radius - k] at offset k,
// zero taps skipped, terms summed in offset order).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define UGSM_API extern "C" __attribute__((visibility("default")))

namespace ugsm {

// Five taps in conv1d storage: the weight at offset k is t[2 - k].
struct Taps5 {
  float t[5];
};

__host__ __device__ inline Taps5 make_taps5(float t0, float t1, float t2,
                                            float t3, float t4) {
  Taps5 tp;
  tp.t[0] = t0;
  tp.t[1] = t1;
  tp.t[2] = t2;
  tp.t[3] = t3;
  tp.t[4] = t4;
  return tp;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One 5-tap pass over samples at offsets -2..2, in conv1d's term order.
__device__ __forceinline__ float pass5(const Taps5& tp, float xm2, float xm1,
                                       float x0, float xp1, float xp2) {
  const float v[5] = {xm2, xm1, x0, xp1, xp2};
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = -2; k <= 2; ++k) {
    const float w = tp.t[2 - k];
    if (w == 0.0f) continue;
    const float term = w * v[k + 2];
    acc = first ? term : acc + term;
    first = false;
  }
  return acc;
}

// Separable 5-tap blur of C planes (H, W): row pass, then column pass,
// zero (clamp == 0) or clamp boundary per pass; square != 0 blurs x*x.
// Defined in blur.cu; launches on `stream`, does not check errors.
void launch_sep5(const float* x, float* out, int C, int H, int W, int clamp,
                 int square, Taps5 taps, cudaStream_t stream);

// The clamp-boundary form for a band of the H-row image (a row shard):
// x holds x_rows rows from global row x_row0; out_rows rows from global
// row out_row0 are written to `out`, whose planes hold out_plane_rows
// rows.  Rows clamp at the image's global edges, so each written row
// equals the whole image's; x must hold every clamped row within 2 of
// them.  Defined in blur.cu.
void launch_sep5_band(const float* x, float* out, int C, int H, int W,
                      int x_row0, int x_rows, int out_row0, int out_rows,
                      int out_plane_rows, int square, Taps5 taps,
                      cudaStream_t stream);

}  // namespace ugsm

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

// pass5 for taps that are all nonzero (the Gaussian): the same terms in
// the same order, without pass5's tests for zero taps.
__device__ __forceinline__ float pass5_all(const Taps5& tp, float xm2,
                                           float xm1, float x0, float xp1,
                                           float xp2) {
  float acc = tp.t[4] * xm2;
  acc = acc + tp.t[3] * xm1;
  acc = acc + tp.t[2] * x0;
  acc = acc + tp.t[1] * xp1;
  return acc + tp.t[0] * xp2;
}

// Asynchronous copy of one float from device memory to shared memory
// (cp.async through L1, for planes no block writes during the launch);
// fill == false writes 0 and reads nothing.  Complete after
// cp_async_wait_all() and, for other threads, a block barrier.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Separable 5-tap blur of C planes (H, W): row pass, then column pass,
// zero (clamp == 0) or clamp boundary per pass.  Defined in blur.cu;
// launches on `stream`, does not check errors.
void launch_sep5(const float* x, float* out, int C, int H, int W, int clamp,
                 Taps5 taps, cudaStream_t stream);

// The clamp-boundary form for a band of the H-row image (a row shard):
// x holds x_rows rows from global row x_row0; out_rows rows from global
// row out_row0 are written to `out`, whose planes hold out_plane_rows
// rows.  Rows clamp at the image's global edges, so each written row
// equals the whole image's; x must hold every clamped row within 2 of
// them.  Defined in blur.cu.
void launch_sep5_band(const float* x, float* out, int C, int H, int W,
                      int x_row0, int x_rows, int out_row0, int out_rows,
                      int out_plane_rows, Taps5 taps, cudaStream_t stream);

}  // namespace ugsm
